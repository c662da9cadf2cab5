"""The port's cluster (``yugabyte_db_tpu_torch.integration.MiniCluster``:
the port's master, tablet servers and client) under the assertions of
the JAX package's ``tests/test_mini_cluster.py``: DDL, writes and reads
through the client, a tserver kill with failover and re-replication,
master failover, a full restart, the socket transport, and the repair of
a replica missing from a live tserver, and the JAX file's two mesh tests
(:266, :316): multi-tablet aggregates and row pages served by the
tserver's ``MeshScanService``. The tablets run on the ``gpu`` engine over
CPU tensors.
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


@pytest.fixture(params=["1x1", "4x2"])
def mesh_shape(request, monkeypatch):
    """The service's own mesh of the CPU (1x1), or the logical 4x2 on the
    CPU (the JAX tests' 8 virtual devices)."""
    if request.param == "4x2":
        import torch

        from yugabyte_db_tpu_torch.parallel import DeviceMesh
        from yugabyte_db_tpu_torch.tserver.mesh_scan import MeshScanService

        monkeypatch.setattr(
            MeshScanService, "_get_mesh",
            lambda self, device: DeviceMesh.logical(torch.device("cpu"), 4,
                                                    2))
    return request.param


def test_mesh_multi_tablet_aggregate(tmp_path, mesh_shape):
    """Multi-tablet aggregates execute as ONE mesh program on the
    tserver (ts.multi_agg_scan -> parallel.sharded_aggregate: K5 over the
    pieces, the mesh combine), not as per-tablet scans merged on the
    client."""
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=1).start()
    try:
        c.wait_tservers_registered(1)
        client = c.client()
        table = client.create_table("mesh", COLUMNS, num_tablets=4,
                                    replication_factor=1)
        from yugabyte_db_tpu_torch.client import YBSession
        s = YBSession(client)
        n = 200
        for i in range(n):
            s.insert(table, {"k": f"key{i}", "r": i, "v": i * 10,
                             "s": f"val-{i}"})
        assert s.flush() == n
        ts = next(iter(c.tservers.values()))
        for peer in ts.tablet_manager.peers():
            peer.flush()
        total = sum(i * 10 for i in range(n))

        def mesh_served():
            # Transient lease/leadership states legitimately fall back to
            # per-tablet scans; results stay correct either way. Retry
            # until the mesh path engages.
            res = s.scan(table, ScanSpec(aggregates=[
                AggSpec("count", None), AggSpec("sum", "v"),
                AggSpec("min", "v"), AggSpec("max", "v"),
                AggSpec("avg", "v")]))
            assert res.rows == [(n, total, 0, 1990, total / n)]
            return ts.mesh_scan.served >= 1
        wait_for(mesh_served, timeout=20.0,
                 msg="aggregate riding the mesh")
        # Device-exact predicate pushdown through the mesh path.
        res2 = s.scan(table, ScanSpec(
            predicates=[Predicate("v", ">=", 1000)],
            aggregates=[AggSpec("count", None)]))
        assert res2.rows == [(100,)]
        assert ts.mesh_scan.served >= 2
        # Ineligible spec (string max needs the host path) falls back and
        # still returns correct results.
        res3 = s.scan(table, ScanSpec(aggregates=[AggSpec("max", "s")]))
        assert res3.rows == [("val-99",)]
        assert ts.mesh_scan.fallbacks >= 1
    finally:
        c.shutdown()


def external_entries() -> int:
    """The residency cache's live external entries (dead owners reaped)."""
    import gc

    from yugabyte_db_tpu_torch.storage.residency import hbm_cache

    gc.collect()
    return hbm_cache().stats()["by_encoding"].get(
        "external", {"entries": 0})["entries"]


def test_mesh_multi_tablet_row_scan(tmp_path, mesh_shape):
    """Row scans over many tablets of one tserver ride the mesh as ONE
    program per page (ts.multi_row_scan -> parallel.sharded_row_page),
    with LIMIT paging chained by the opaque cross-tablet resume token; a
    flush replacing a tablet's run refreshes the cached stack (in-place
    update or rebuild+close) without leaking residency pins (external
    entries counted against the process's before the cluster started:
    other tests' engines and stacks may still hold theirs)."""
    base = external_entries()
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=1).start()
    try:
        c.wait_tservers_registered(1)
        client = c.client()
        table = client.create_table("meshrow", COLUMNS, num_tablets=4,
                                    replication_factor=1)
        from yugabyte_db_tpu_torch.client import YBSession
        s = YBSession(client)
        n = 240
        for i in range(n):
            s.insert(table, {"k": f"key{i}", "r": i, "v": i * 10,
                             "s": f"val-{i}"})
        assert s.flush() == n
        ts = next(iter(c.tservers.values()))
        for peer in ts.tablet_manager.peers():
            peer.flush()
        want = sorted((f"key{i}", i, i * 10, f"val-{i}")
                      for i in range(n))

        def mesh_served():
            res = s.scan(table, ScanSpec())
            assert sorted(res.rows) == want
            return ts.mesh_scan.served_rows >= 1
        wait_for(mesh_served, timeout=20.0, msg="rows riding the mesh")
        # LIMIT + device-exact predicate through the mesh path.
        res2 = s.scan(table, ScanSpec(
            predicates=[Predicate("v", ">=", 1200)], limit=50))
        assert len(res2.rows) == 50
        assert all(r[2] >= 1200 for r in res2.rows)
        # A page of 7 rows chains across tablets by the resume token.
        before = ts.mesh_scan.served_rows
        res3 = s.scan(table, ScanSpec(limit=7))
        assert len(res3.rows) == 7
        assert ts.mesh_scan.served_rows > before
        # A flush replacing one tablet's run supersedes the cached
        # stack; the next scan re-serves the NEW data on the mesh.
        for i in range(n, n + 40):
            s.insert(table, {"k": f"key{i}", "r": i, "v": i * 10,
                             "s": f"val-{i}"})
        s.flush()
        for peer in ts.tablet_manager.peers():
            peer.flush()
            peer.compact()
        want2 = sorted((f"key{i}", i, i * 10, f"val-{i}")
                       for i in range(n + 40))

        def mesh_served_again():
            before = ts.mesh_scan.served_rows
            res = s.scan(table, ScanSpec())
            assert sorted(res.rows) == want2
            return ts.mesh_scan.served_rows > before
        wait_for(mesh_served_again, timeout=20.0,
                 msg="post-flush rows riding the mesh")
        # Stack cache bounded; superseded stacks released their pins.
        assert len(ts.mesh_scan._stacks) <= ts.mesh_scan._max_cached
        assert external_entries() - base <= ts.mesh_scan._max_cached + 4
    finally:
        c.shutdown()


def test_mesh_dispatch_fault_drops_every_stack(tmp_path):
    """An armed ``fault.mesh_dispatch`` (a chip lost mid-scan) drops every
    cached stack: the ``device/sharded`` charge reads 0, the reply falls
    back to the per-tablet path with the right answer, and
    ``chip_losses`` and ``fallbacks`` count it; the next scan rebuilds
    and rides the mesh again. (The charge is read against the process's
    before the cluster started: 0 when no other stack lives.)"""
    import gc

    from yugabyte_db_tpu_torch.client import YBSession
    from yugabyte_db_tpu_torch.storage.residency import hbm_cache
    from yugabyte_db_tpu_torch.utils.fault_injection import arm_fault_once
    from yugabyte_db_tpu_torch.utils.memtracker import root_tracker

    tracker = root_tracker().child("device").child("sharded")
    gc.collect()
    hbm_cache().stats()  # reap stacks of clusters gone before this one
    base = tracker.consumption
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=1).start()
    try:
        c.wait_tservers_registered(1)
        client = c.client()
        table = client.create_table("meshfault", COLUMNS, num_tablets=4,
                                    replication_factor=1)
        s = YBSession(client)
        for i in range(100):
            s.insert(table, {"k": f"key{i}", "r": i, "v": i,
                             "s": f"val-{i}"})
        assert s.flush() == 100
        ts = next(iter(c.tservers.values()))
        for peer in ts.tablet_manager.peers():
            peer.flush()
        spec = ScanSpec(aggregates=[AggSpec("count", None),
                                    AggSpec("sum", "v")])
        wait_for(lambda: s.scan(table, spec).rows == [(100, 4950)]
                 and ts.mesh_scan.served >= 1, timeout=20.0,
                 msg="aggregate riding the mesh")
        assert ts.mesh_scan._stacks and tracker.consumption > base
        served, losses = ts.mesh_scan.served, ts.mesh_scan.chip_losses
        fallbacks = ts.mesh_scan.fallbacks
        arm_fault_once("fault.mesh_dispatch")
        assert s.scan(table, spec).rows == [(100, 4950)]
        assert ts.mesh_scan.chip_losses == losses + 1
        assert ts.mesh_scan.fallbacks == fallbacks + 1
        assert ts.mesh_scan.served == served
        assert not ts.mesh_scan._stacks
        assert tracker.consumption == base
        assert s.scan(table, spec).rows == [(100, 4950)]
        assert ts.mesh_scan.served == served + 1
    finally:
        c.shutdown()


def test_mesh_scans_after_alter_table(tmp_path):
    """ALTER TABLE grows the tablets' runs in place (the same run objects
    under a new schema version): the service builds a new stack for the
    new schema instead of serving the cached one, so a page projecting
    the added column rides the mesh, the old rows reading it as NULL."""
    from yugabyte_db_tpu_torch.client import YBSession

    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=1).start()
    try:
        c.wait_tservers_registered(1)
        client = c.client()
        table = client.create_table("meshalter", COLUMNS, num_tablets=4,
                                    replication_factor=1)
        s = YBSession(client)
        for i in range(80):
            s.insert(table, {"k": f"key{i}", "r": i, "v": i, "s": f"v{i}"})
        assert s.flush() == 80
        ts = next(iter(c.tservers.values()))
        for peer in ts.tablet_manager.peers():
            peer.flush()
        wait_for(lambda: len(s.scan(table, ScanSpec()).rows) == 80
                 and ts.mesh_scan.served_rows >= 1, timeout=20.0,
                 msg="rows riding the mesh")
        new = table.schema.with_added_column("w", DataType.INT64)
        client.alter_table("meshalter", new.to_dict())
        table = client.open_table("meshalter")
        before = ts.mesh_scan.served_rows
        res = s.scan(table, ScanSpec(projection=["k", "r", "w"]))
        assert sorted(res.rows) == sorted((f"key{i}", i, None)
                                          for i in range(80))
        assert ts.mesh_scan.served_rows > before
    finally:
        c.shutdown()
