"""Tablet snapshots on the port's cluster, under the assertions of the JAX
package's ``tests/test_snapshot.py``: create / restore / delete,
replicated and replayed, per tablet and coordinated by the master. The
JAX tests drive them through ``tools.admin_client.AdminClient``, which
the port has not (ROADMAP.md §1 item 16); here ``AdminClient`` is a copy
of its snapshot RPCs over the port's transport. The tablets run on the ``gpu``
engine over CPU tensors; the JAX file's local-tablet test, which loops
over the JAX engines ``cpu`` and ``tpu``, runs on ``gpu``.
"""

import tempfile
import time

import pytest

from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.client.session import YBSession
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema
from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec
from yugabyte_db_tpu_torch.consensus.transport import TransportError


class AdminError(Exception):
    pass


class AdminClient:
    """The snapshot RPCs of the JAX ``tools/admin_client.py``
    (``snapshot_table``, ``cluster_snapshot``, ``list_snapshots`` and the
    master and leader loops under them), over the port's transport."""

    def __init__(self, transport, master_uuids: list[str]):
        self.transport = transport
        self.master_uuids = list(master_uuids)

    def master_rpc(self, method: str, payload: dict | None = None,
                   timeout_s: float = 10.0) -> dict:
        deadline = time.monotonic() + timeout_s
        last = None
        while time.monotonic() < deadline:
            for m in list(self.master_uuids):
                try:
                    resp = self.transport.send(m, method, payload or {},
                                               timeout=2.0)
                except TransportError as e:
                    last = str(e)
                    continue
                if resp.get("code") == "not_leader":
                    last = "not_leader"
                    continue
                return resp
            time.sleep(0.1)
        raise AdminError(f"no leader master answered {method}: {last}")

    def table_locations(self, table: str) -> list[dict]:
        resp = self.master_rpc("master.get_table_locations",
                               {"name": table})
        if resp.get("code") != "ok":
            raise AdminError(f"table {table}: {resp.get('code')}")
        return resp["tablets"]

    def _leader_rpc(self, tablet_id: str, method: str, payload: dict,
                    timeout_s: float = 10.0) -> dict:
        deadline = time.monotonic() + timeout_s
        last = "unreachable"
        while True:
            loc = self.master_rpc("master.locate_tablet",
                                  {"tablet_id": tablet_id})
            hint = loc.get("leader")
            candidates = ([hint] if hint else []) + [
                r for r in loc["replicas"] if r != hint]
            for target in candidates:
                try:
                    resp = self.transport.send(target, method, payload,
                                               timeout=3.0)
                except TransportError as e:
                    last = str(e)
                    continue
                if resp.get("code") == "not_leader":
                    last = "not_leader"
                    continue
                return resp
            if time.monotonic() >= deadline:
                raise AdminError(
                    f"{method} on {tablet_id}: no leader reachable ({last})")
            time.sleep(0.2)

    def snapshot_table(self, table: str, snapshot_id: str,
                       op: str = "create_snapshot") -> int:
        n = 0
        for t in self.table_locations(table):
            resp = self._leader_rpc(t["tablet_id"], "ts.snapshot_op",
                                    {"tablet_id": t["tablet_id"],
                                     "snapshot_id": snapshot_id, "op": op})
            if resp.get("code") != "ok":
                raise AdminError(
                    f"{op} {snapshot_id} on {t['tablet_id']}: "
                    f"{resp.get('message', resp.get('code'))}")
            n += 1
        return n

    def cluster_snapshot(self, action: str, table: str | None = None,
                         snapshot_id: str | None = None) -> dict:
        payload = {"action": action}
        if table is not None:
            payload["table"] = table
        if snapshot_id is not None:
            payload["snapshot_id"] = snapshot_id
        resp = self.master_rpc("master.snapshot_op", payload)
        if resp.get("code") != "ok":
            raise AdminError(
                f"snapshot {action}: "
                f"{resp.get('message', resp.get('code'))}")
        return resp

    def list_snapshots(self, table: str) -> dict[str, list[str]]:
        out = {}
        for t in self.table_locations(table):
            resp = self._leader_rpc(t["tablet_id"], "ts.list_snapshots",
                                    {"tablet_id": t["tablet_id"]})
            out[t["tablet_id"]] = resp.get("snapshots", [])
        return out


def _rows(client, table, read_names=("k", "v")):
    s = YBSession(client)
    res = s.scan(table, ScanSpec(projection=list(read_names)))
    return sorted(res.rows)


def test_snapshot_create_restore_delete_cluster():
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            client = mc.client()
            client.create_table("kv", [
                ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
                ColumnSchema("v", DataType.INT64),
            ], num_tablets=4)
            table = client.open_table("kv")
            s = YBSession(client)
            for i in range(30):
                s.insert(table, {"k": f"a{i:03d}", "v": i})
            s.flush()

            admin = AdminClient(mc.transport.bind("admin"),
                                mc.master_uuids)
            n = admin.snapshot_table("kv", "snap1", "create_snapshot")
            assert n == 4
            snaps = admin.list_snapshots("kv")
            assert all(s == ["snap1"] for s in snaps.values())

            # diverge: overwrite some rows, add others, delete one
            for i in range(10):
                s.insert(table, {"k": f"a{i:03d}", "v": -1})
            for i in range(30, 40):
                s.insert(table, {"k": f"a{i:03d}", "v": i})
            s.delete(table, {"k": "a020"})
            s.flush()
            before = _rows(client, table)
            assert len(before) == 39 and ("a000", -1) in before

            admin.snapshot_table("kv", "snap1", "restore_snapshot")
            after = _rows(client, table)
            assert after == [(f"a{i:03d}", i) for i in range(30)]

            admin.snapshot_table("kv", "snap1", "delete_snapshot")
            assert all(s == [] for s in
                       admin.list_snapshots("kv").values())
            # restoring a deleted snapshot fails cleanly
            with pytest.raises(AdminError):
                admin.snapshot_table("kv", "snap1", "restore_snapshot")
        finally:
            mc.shutdown()


def test_snapshot_survives_restart():
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            client = mc.client()
            client.create_table("kv", [
                ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
                ColumnSchema("v", DataType.INT64),
            ], num_tablets=2)
            table = client.open_table("kv")
            s = YBSession(client)
            for i in range(10):
                s.insert(table, {"k": f"k{i}", "v": i})
            s.flush()
            admin = AdminClient(mc.transport.bind("admin2"),
                                mc.master_uuids)
            admin.snapshot_table("kv", "s1", "create_snapshot")
            for i in range(10):
                s.insert(table, {"k": f"k{i}", "v": i * 100})
            s.flush()

            victim = next(iter(mc.tservers))
            mc.stop_tserver(victim)
            mc.restart_tserver(victim)
            mc.wait_tservers_registered()

            # snapshot still listed after restart + WAL replay
            snaps = admin.list_snapshots("kv")
            assert all("s1" in v for v in snaps.values())
            admin.snapshot_table("kv", "s1", "restore_snapshot")
            assert _rows(client, table) == [(f"k{i}", i)
                                            for i in range(10)]
        finally:
            mc.shutdown()


def test_snapshot_local_tablet():
    """The JAX test runs its local tablet on the engines ``cpu`` and
    ``tpu``; the port's runs on ``gpu``."""
    import os

    from yugabyte_db_tpu_torch.models.partition import compute_hash_code
    from yugabyte_db_tpu_torch.models.schema import Schema
    from yugabyte_db_tpu_torch.storage.row_version import RowVersion
    from yugabyte_db_tpu_torch.tablet.tablet import Tablet, TabletMetadata

    with tempfile.TemporaryDirectory() as root:
        schema = Schema([
            ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
            ColumnSchema("v", DataType.INT64),
        ], table_id="t")
        cid = schema.column("v").col_id
        meta = TabletMetadata("t-0001", "t", schema, 0, 65536,
                              engine="gpu")
        t = Tablet.create(meta, root, fsync=False,
                          engine_options={"device": "cpu"})

        def key(i):
            return schema.encode_primary_key(
                {"k": f"x{i}"},
                compute_hash_code(schema, {"k": f"x{i}"}))

        t.write([RowVersion(key(i), ht=0, liveness=True,
                            columns={cid: i}) for i in range(8)])
        t.snapshot_op("create_snapshot", "base")
        t.write([RowVersion(key(i), ht=0, liveness=True,
                            columns={cid: -i}) for i in range(8)])
        res = t.scan(ScanSpec(read_ht=t.read_time().value,
                              projection=["k", "v"]))
        assert all(v <= 0 for _k, v in res.rows)
        t.snapshot_op("restore_snapshot", "base")
        res = t.scan(ScanSpec(read_ht=t.read_time().value,
                              projection=["k", "v"]))
        assert sorted(v for _k, v in res.rows) == list(range(8))
        assert t.list_snapshots() == ["base"]
        t.snapshot_op("delete_snapshot", "base")
        assert t.list_snapshots() == []
        assert os.path.isdir(t.dir)
        t.close()


def test_master_coordinated_cluster_snapshot():
    """The master drives create/restore/delete across every tablet and
    tracks snapshot state in the replicated sys catalog (reference:
    CreateSnapshot/RestoreSnapshot master RPCs over backup.proto ops);
    the registry survives a full cluster kill + restart, and restore
    after the restart still rolls data back."""
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(root, num_tservers=3).start()
        try:
            mc.wait_tservers_registered()
            client = mc.client()
            client.create_table("kv", [
                ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
                ColumnSchema("v", DataType.INT64),
            ], num_tablets=4)
            table = client.open_table("kv")
            s = YBSession(client)
            for i in range(40):
                s.insert(table, {"k": f"a{i:03d}", "v": i})
            s.flush()
            baseline = _rows(client, table)

            admin = AdminClient(mc.transport.bind("admin2"),
                                mc.master_uuids)
            resp = admin.cluster_snapshot("create", "kv", "cs1")
            assert resp["tablets"] == 4
            reg = admin.cluster_snapshot("list")["snapshots"]
            assert reg["cs1"]["state"] == "COMPLETE"
            assert reg["cs1"]["table"] == "kv"

            # unknown snapshot / double create fail cleanly
            with pytest.raises(Exception):
                admin.cluster_snapshot("restore", snapshot_id="nope")
            with pytest.raises(Exception):
                admin.cluster_snapshot("create", "kv", "cs1")

            # diverge
            for i in range(20):
                s.insert(table, {"k": f"a{i:03d}", "v": i + 1000})
            for i in range(40, 55):
                s.insert(table, {"k": f"a{i:03d}", "v": i})
            s.flush()
            assert _rows(client, table) != baseline

            # kill the whole cluster; registry must survive the restart
            mc.shutdown()
            mc = MiniCluster(root, num_tservers=3).start()
            mc.wait_tservers_registered()
            client = mc.client("after-restart")
            table = client.open_table("kv")
            admin = AdminClient(mc.transport.bind("admin3"),
                                mc.master_uuids)
            reg = admin.cluster_snapshot("list")["snapshots"]
            assert reg["cs1"]["state"] == "COMPLETE"

            # The master sends the restore to each tablet's leader and
            # fails a tablet whose replicas all answer not_leader: every
            # tablet serves a read (a leader elected) first.
            assert _rows(client, table) != baseline
            admin.cluster_snapshot("restore", snapshot_id="cs1")
            assert _rows(client, table) == baseline

            admin.cluster_snapshot("delete", snapshot_id="cs1")
            assert admin.cluster_snapshot("list")["snapshots"] == {}
            with pytest.raises(Exception):
                admin.cluster_snapshot("restore", snapshot_id="cs1")
        finally:
            mc.shutdown()
