"""Topology-aware placement and read replicas on the port's cluster, under
the assertions of the JAX package's ``tests/test_topology.py``. The
tablets run on the ``gpu`` engine over CPU tensors.
"""

import tempfile
import time

import pytest

from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.client.session import YBSession
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema
from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec

COLUMNS = [ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
           ColumnSchema("v", DataType.INT64)]

ZONES = {f"ts-{i}": {"cloud": "c1", "region": "r1", "zone": f"z{i % 3}"}
         for i in range(6)}


def _zone_spread(mc, master, table_name):
    """Per tablet: the set of zones its replicas occupy."""
    t = master.catalog.table_by_name(table_name)
    spreads = []
    for info in master.catalog.tablets_of(t.table_id):
        zones = {master.ts_manager.cloud_info_of(r).get("zone")
                 for r in info.replicas}
        spreads.append((info.tablet_id, info.replicas, zones))
    return spreads


def test_rf3_spreads_across_three_zones():
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=6,
                         ts_cloud_info=ZONES).start()
        try:
            mc.wait_tservers_registered()
            client = mc.client()
            client.create_table("zt", COLUMNS, num_tablets=6)
            master = mc.leader_master()
            for tablet_id, replicas, zones in _zone_spread(mc, master,
                                                           "zt"):
                assert len(zones) == 3, (tablet_id, replicas, zones)
        finally:
            mc.shutdown()


def test_zone_kill_rereplicates_to_survivors():
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=6, ts_cloud_info=ZONES,
                         ts_unresponsive_timeout_s=1.0).start()
        try:
            mc.wait_tservers_registered()
            client = mc.client()
            client.create_table("zk", COLUMNS, num_tablets=4)
            table = client.open_table("zk")
            s = YBSession(client)
            for i in range(200):
                s.insert(table, {"k": f"r{i:04d}", "v": i})
            s.flush()
            # Kill zone z0 entirely (ts-0 and ts-3).
            mc.stop_tserver("ts-0")
            mc.stop_tserver("ts-3")
            master = mc.leader_master()
            dead = {"ts-0", "ts-3"}
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                spreads = _zone_spread(mc, master, "zk")
                if all(not (set(reps) & dead) for _t, reps, _z in spreads):
                    break
                time.sleep(0.3)
            spreads = _zone_spread(mc, master, "zk")
            for tablet_id, replicas, zones in spreads:
                assert not (set(replicas) & dead), (tablet_id, replicas)
                # Two zones survive: best possible spread is 2 zones.
                assert len(zones) == 2, (tablet_id, replicas, zones)
            # Ack'd data survives the zone loss.
            res = YBSession(client).scan(
                table, ScanSpec(projection=["k", "v"]))
            assert len(res.rows) == 200
        finally:
            mc.shutdown()


def test_stale_read_prefers_same_zone_replica():
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=6,
                         ts_cloud_info=ZONES).start()
        try:
            mc.wait_tservers_registered()
            admin = mc.client()
            admin.create_table("sr", COLUMNS, num_tablets=2)
            table = admin.open_table("sr")
            s = YBSession(admin)
            for i in range(50):
                s.insert(table, {"k": f"s{i:03d}", "v": i})
            s.flush()
            client = mc.client("zoned", cloud_info=ZONES["ts-1"])
            sess = YBSession(client)
            # Spy on transport targets to verify same-zone routing.
            targets = []
            inner_send = client.transport.send

            def spy(dst, method, payload, timeout=5.0):
                if method == "ts.scan":
                    targets.append(dst)
                return inner_send(dst, method, payload, timeout)

            client.transport.send = spy
            # Stale reads serve a replica's APPLIED state: allow the
            # follower a moment to catch up (bounded staleness).
            deadline = time.monotonic() + 10.0
            while True:
                targets.clear()
                res = sess.scan(table, ScanSpec(projection=["k", "v"]),
                                stale_ok=True)
                if len(res.rows) == 50 or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            assert len(res.rows) == 50
            same_zone = {u for u, ci in ZONES.items()
                         if ci == ZONES["ts-1"]}
            locs = client.meta_cache.locations("sr")
            for dst, loc in zip(targets, locs.tablets):
                expected = {r for r in loc.replicas if r in same_zone}
                if expected:  # a same-zone replica exists: must be used
                    assert dst in expected, (dst, loc.replicas)
            # Strong read still routes to the leader and agrees.
            res2 = sess.scan(table, ScanSpec(projection=["k", "v"]))
            assert sorted(res2.rows) == sorted(res.rows)
        finally:
            mc.shutdown()


def test_unlabeled_cluster_still_places():
    """Zone-awareness must not regress unlabeled clusters (everyone in
    the one empty zone: pure least-loaded spread)."""
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            client = mc.client()
            client.create_table("ul", COLUMNS, num_tablets=4)
            master = mc.leader_master()
            for _t, replicas, _z in _zone_spread(mc, master, "ul"):
                assert len(set(replicas)) == 3
        finally:
            mc.shutdown()


def test_stale_aggregate_honors_zone_routing():
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=6,
                         ts_cloud_info=ZONES).start()
        try:
            mc.wait_tservers_registered()
            admin = mc.client()
            admin.create_table("sa", COLUMNS, num_tablets=2)
            table = admin.open_table("sa")
            s = YBSession(admin)
            for i in range(60):
                s.insert(table, {"k": f"a{i:03d}", "v": i})
            s.flush()
            from yugabyte_db_tpu_torch.storage.scan_spec import AggSpec
            client = mc.client("zoned", cloud_info=ZONES["ts-2"])
            sess = YBSession(client)
            spec = ScanSpec(aggregates=[AggSpec("count", None),
                                        AggSpec("sum", "v")])
            deadline = time.monotonic() + 10.0
            while True:
                res = sess.scan(table, spec, stale_ok=True)
                if res.rows[0] == (60, sum(range(60))) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            assert res.rows[0] == (60, sum(range(60)))
        finally:
            mc.shutdown()
