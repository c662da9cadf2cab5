"""The port's tablet server (``yugabyte_db_tpu_torch/tserver``, ``fs``,
``server/daemon_main``) against the JAX package's.

- Mirrors of ``tests/test_fs_identity_deploy.py``'s data-directory identity
  tests (:16, :24, :31) on the port's ``fs`` and ``TabletServer``.
- Mirrors, at the RPC level, of ``tests/test_bootstrap_retry.py``'s four
  tests (:38, :73, :103, :179): the JAX tests run a ``MiniCluster`` and its
  client; here the test plays the master and the client itself, creating
  the tablet with ``ts.create_tablet`` on each of three port tablet
  servers over a ``LocalTransport`` and writing and reading through their
  RPC handlers (their ``MiniCluster`` forms are in
  ``tests/test_torch_cluster_bootstrap.py``).
  The tablets run on the ``gpu`` engine over CPU tensors.
- ``install_snapshot``'s term fencing.
- A differential: three JAX tablet servers (the ``tpu`` engine on the CPU
  backend) and three port tablet servers take the same RPC script, and
  their replies are equal once hybrid times and uuids are left out.
- A remote-bootstrap payload of a JAX tablet server's ``ts.rb_snapshot``,
  installed by the port's ``TSTabletManager``: every file equals the JAX
  install's byte for byte, and the port's replica serves the same rows.
- Three ``python -m yugabyte_db_tpu_torch.server.daemon_main --role tserver
  --device cpu`` processes over loopback sockets, and a ``--role master``
  daemon that a tserver daemon registers with and a ``YBClient`` creates
  a table through.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

import test_torch_data as D
import yugabyte_db_tpu.consensus as JC
import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu.tserver.tablet_manager as j_tm
import yugabyte_db_tpu.tserver.tablet_server as j_ts
from yugabyte_db_tpu.models import datatypes as j_dt
from yugabyte_db_tpu.models import partition as j_partition
from yugabyte_db_tpu.models import schema as j_schema
from yugabyte_db_tpu.storage import wire as j_wire
from yugabyte_db_tpu_torch import fs as yfs
from yugabyte_db_tpu_torch import consensus as TC
from yugabyte_db_tpu_torch import storage as T
from yugabyte_db_tpu_torch.models import datatypes as t_dt
from yugabyte_db_tpu_torch.models import partition as t_partition
from yugabyte_db_tpu_torch.models import schema as t_schema
from yugabyte_db_tpu_torch.storage import wire as t_wire
from yugabyte_db_tpu_torch.tserver import tablet_manager as t_tm
from yugabyte_db_tpu_torch.tserver import tablet_server as t_ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = ["ts-0", "ts-1", "ts-2"]
TID = "tablet-1"


class Side:
    def __init__(self, name, C, S, wire, schema, dt, partition, ts, tm):
        self.name, self.C, self.S, self.wire = name, C, S, wire
        self.schema, self.dt, self.partition = schema, dt, partition
        self.ts, self.tm = ts, tm


JAXSIDE = Side("jax", JC, J, j_wire, j_schema, j_dt, j_partition, j_ts, j_tm)
PORTSIDE = Side("port", TC, T, t_wire, t_schema, t_dt, t_partition, t_ts,
                t_tm)


def wait_for(pred, timeout=30.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def kv_schema(side):
    """``tests/test_bootstrap_retry.py``'s table."""
    S, DT = side.schema, side.dt.DataType
    return S.Schema([S.ColumnSchema("k", DT.STRING, S.ColumnKind.HASH),
                     S.ColumnSchema("v", DT.INT64)], table_id="t")


def bench_schema(side):
    S, DT = side.schema, side.dt.DataType
    return S.Schema([S.ColumnSchema("k", DT.STRING, S.ColumnKind.HASH),
                     S.ColumnSchema("r", DT.INT64, S.ColumnKind.RANGE),
                     S.ColumnSchema("a", DT.INT64),
                     S.ColumnSchema("c", DT.DOUBLE),
                     S.ColumnSchema("d", DT.INT32)], table_id="bench")


class Cluster:
    """Three tablet servers of one package over its ``LocalTransport``;
    the test is their master and their client. The port's tablets run on
    the ``gpu`` engine over CPU tensors."""

    def __init__(self, root, side=PORTSIDE, schema=None, engine=None):
        self.root, self.side = str(root), side
        self.schema = schema if schema is not None else kv_schema(side)
        self.engine = engine
        self.transport = side.C.LocalTransport()
        self.client = self.transport.bind("client")
        self.opts = side.C.RaftOptions(election_timeout_s=0.25,
                                       heartbeat_interval_s=0.05,
                                       lease_s=0.6, rpc_timeout_s=1.0)
        self.servers = {}
        self.retried = []
        self.request_id = 0
        for uuid in NODES:
            self.start(uuid)

    def start(self, uuid):
        opts = {"device": "cpu"} if self.side is PORTSIDE else None
        ts = self.side.ts.TabletServer(
            uuid, os.path.join(self.root, uuid), self.transport.bind(uuid),
            ["m-0"], raft_opts=self.opts, engine_options=opts, fsync=False)
        self.transport.register(uuid, ts.handle)
        ts.start()
        self.servers[uuid] = ts
        return ts

    def stop(self, uuid):
        self.transport.unregister(uuid)
        self.servers.pop(uuid).shutdown()

    def shutdown(self):
        for uuid in list(self.servers):
            self.stop(uuid)

    def call(self, uuid, method, payload, timeout=60.0):
        return self.client.send(uuid, method, payload, timeout=timeout)

    def create(self):
        p = {"tablet_id": TID, "table_name": "t",
             "schema": self.schema.to_dict(), "partition_start": 0,
             "partition_end": 65536, "peers": list(NODES)}
        if self.engine is not None:
            p["engine"] = self.engine
        for uuid in NODES:
            assert self.call(uuid, "ts.create_tablet", p) == {"code": "ok"}

    def peer(self, uuid):
        return self.servers[uuid].tablet_manager.get(TID)

    def settle(self):
        """Wait until every replica has applied the leader's commit
        index: a flush or a compaction on each replica then leaves the
        same runs on all of them, whichever leads later."""
        target = self.peer(self.leader()).raft.stats()["commit_index"]
        for uuid in NODES:
            wait_for(lambda uuid=uuid: self.peer(uuid).raft.stats()[
                "applied_index"] >= target, msg=f"{uuid} to apply")

    def leader(self, exclude=()) -> str:
        def ready():
            for uuid, ts in self.servers.items():
                if uuid in exclude:
                    continue
                try:
                    p = ts.tablet_manager.get(TID)
                except Exception:  # noqa: BLE001 — not open yet
                    continue
                if p.raft.is_leader() and p.raft.has_lease() \
                        and p.raft.leader_ready():
                    return uuid
            return None
        return wait_for(ready, msg="a leader with a lease")

    def on_leader(self, method, payload, timeout=60.0) -> dict:
        """One RPC to the leader, retried on ``not_leader`` and
        ``timed_out`` as a client does. The client's budget for the
        server's waits (``timeout`` in the payload) is generous: a loaded
        test host serves even a small batch slowly."""
        deadline = time.monotonic() + 120.0
        while True:
            resp = self.call(self.leader(), method,
                             {"timeout": timeout, **payload,
                              "tablet_id": TID}, timeout=timeout)
            if resp.get("code") not in ("not_leader", "timed_out"):
                return resp
            self.retried.append((method, resp.get("code")))
            assert time.monotonic() < deadline, (method, resp)
            time.sleep(0.02)

    def key(self, k, r=None):
        d = {"k": k} if r is None else {"k": k, "r": r}
        return self.schema.encode_primary_key(
            d, self.side.partition.compute_hash_code(self.schema, {"k": k}))

    def kv_rows(self, prefix, start, n):
        cid = {c.name: c.col_id for c in self.schema.columns}
        return [self.side.S.RowVersion(self.key(f"{prefix}{i}"), ht=0,
                                       liveness=True, columns={cid["v"]: i})
                for i in range(start, start + n)]

    def write(self, rows, **ids) -> dict:
        """One ``ts.write`` through the leader. Every write carries a
        (client_id, request_id), the caller's or the next of this client,
        so that ``on_leader``'s retry after ``timed_out`` applies it once,
        as a real client's retry does."""
        if not ids:
            self.request_id += 1
            ids = {"client_id": "test-client",
                   "request_id": self.request_id}
        resp = self.on_leader("ts.write",
                              {"rows": self.side.wire.encode_rows(rows),
                               **ids})
        assert resp["code"] == "ok", resp
        return resp

    def scan(self, spec) -> dict:
        return self.on_leader("ts.scan",
                              {"spec": self.side.wire.encode_spec(spec)})

    def all_rows(self, projection=("k",)) -> list:
        rows, lower = [], b""
        while True:
            resp = self.scan(self.side.S.ScanSpec(
                lower=lower, projection=list(projection), limit=500))
            assert resp["code"] == "ok", resp
            rows += [tuple(r) for r in resp["rows"]]
            if resp["resume_key"] is None:
                return rows
            lower = resp["resume_key"]


@pytest.fixture
def cluster(tmp_path):
    c = Cluster(tmp_path)
    c.create()
    yield c
    c.shutdown()


# -- tests/test_fs_identity_deploy.py:16, :24, :31 -------------------------

def test_instance_metadata_format_and_reopen(tmp_path):
    d = str(tmp_path / "ts-data")
    meta = yfs.format_or_open(d, "ts-1")
    assert meta["server_uuid"] == "ts-1" and meta["instance_uuid"]
    again = yfs.format_or_open(d, "ts-1")
    assert again["instance_uuid"] == meta["instance_uuid"]


def test_instance_metadata_rejects_swapped_dir(tmp_path):
    d = str(tmp_path / "ts-data")
    yfs.format_or_open(d, "ts-1")
    with pytest.raises(yfs.FsMismatch):
        yfs.format_or_open(d, "ts-2")


def test_daemons_refuse_foreign_data_dir(tmp_path):
    root = str(tmp_path / "node")
    t = TC.LocalTransport()
    ts = t_ts.TabletServer("ts-a", root, t, ["m-0"], fsync=False)
    with pytest.raises(yfs.FsMismatch):
        t_ts.TabletServer("ts-b", root, TC.LocalTransport(), ["m-0"],
                          fsync=False)
    assert ts.instance["server_uuid"] == "ts-a"


def test_instance_files_cross_packages(tmp_path):
    """Either package opens the other's instance file (the same codec
    record) and refuses it for another server."""
    from yugabyte_db_tpu import fs as jfs

    mine = yfs.format_or_open(str(tmp_path / "a"), "ts-1")
    assert jfs.format_or_open(str(tmp_path / "a"), "ts-1") == mine
    theirs = jfs.format_or_open(str(tmp_path / "b"), "ts-2")
    assert yfs.format_or_open(str(tmp_path / "b"), "ts-2") == theirs
    with pytest.raises(jfs.FsMismatch):
        jfs.format_or_open(str(tmp_path / "a"), "ts-9")


# -- tests/test_bootstrap_retry.py:38, :73, :103, :179 at the RPC level -----

def test_exactly_once_duplicate_write(cluster):
    """The same (client_id, request_id) applied twice writes ONCE and the
    duplicate returns the original hybrid time."""
    rows = cluster.kv_rows("dup", 1, 1)
    payload = {"client_id": "client-1", "request_id": 7}
    r1 = cluster.write(rows, **payload)
    r2 = cluster.write(rows, **payload)
    assert r1["ht"] == r2["ht"], "duplicate must return original ht"
    peer = cluster.peer(cluster.leader())
    versions = peer.tablet.engine.memtable.versions(rows[0].key)
    assert len(list(versions)) == 1
    # dedup state survives flush
    peer.flush()
    assert peer.tablet.retryable.seen("client-1", 7) == r1["ht"]


def test_log_cache_eviction_bounded(cluster):
    for i in range(0, 300, 2):
        cluster.write(cluster.kv_rows("x", i, 2))
    for uuid in NODES:
        peer = cluster.peer(uuid)
        before = len(peer.raft._entries)
        assert cluster.call(uuid, "ts.flush", {"tablet_id": TID}) == \
            {"code": "ok"}
        after = len(peer.raft._entries)
        assert after <= before
        assert after < 100, f"cache not bounded: {after}"
    # reads still correct after eviction
    assert len(cluster.all_rows(("k", "v"))) == 300


def test_remote_bootstrap_after_log_gc(cluster):
    """Kill a replica, write + flush past log GC on the survivors, restart
    it: it must catch up by one remote-bootstrap install, not log replay,
    and hold the 200 rows."""
    cluster.write(cluster.kv_rows("a", 0, 50))
    leader = cluster.leader()
    victim = next(u for u in NODES if u != leader)
    cluster.stop(victim)
    # Many separate write batches (one raft entry each) so the victim's
    # position falls far below the eviction floor.
    for r in range(30):
        cluster.write(cluster.kv_rows("b", r * 5, 5))
    for uuid in list(cluster.servers):
        assert cluster.call(uuid, "ts.flush", {"tablet_id": TID}) == \
            {"code": "ok"}
        assert min(cluster.peer(uuid).raft._entries, default=10**9) > 3

    ts = cluster.start(victim)

    def caught_up():
        if ts.tablet_manager.bootstrap_installs < 1:
            return False
        try:
            peer = ts.tablet_manager.get(TID)
        except Exception:  # noqa: BLE001 — mid-install
            return False
        lead = cluster.peer(cluster.leader(exclude=(victim,)))
        return peer.raft.stats()["applied_index"] >= \
            lead.raft.stats()["commit_index"] - 1
    wait_for(caught_up, timeout=60.0, msg="remote bootstrap catch-up")
    assert ts.tablet_manager.bootstrap_installs == 1
    peer = ts.tablet_manager.get(TID)
    res = peer.tablet.engine.scan(T.ScanSpec(projection=["k"]))
    assert len(res.rows) == 200  # 50 a-keys + 150 b-keys
    # ... and answers a checksum equal to the leader's at one read point.
    read_ht = cluster.on_leader("ts.checksum", {})["read_ht"]
    sums = {u: cluster.call(u, "ts.checksum", {"tablet_id": TID,
                                               "read_ht": read_ht,
                                               "timeout": 60.0}, 60.0)
            for u in NODES}
    assert len({(s["rows"], s["checksum"]) for s in sums.values()}) == 1
    assert sums[victim]["rows"] == 200


def test_crash_recovery_replays_wal_and_dedups_retries(cluster):
    """A WAL sync fault mid-workload, then a crash-restart of the leader:
    its tablet comes back by WAL replay with every acked row, and a
    re-sent (client_id, request_id) write dedups to the ORIGINAL hybrid
    time."""
    from yugabyte_db_tpu_torch.utils.fault_injection import arm_fault_once
    from yugabyte_db_tpu_torch.utils.metrics import faults_fired

    cluster.write(cluster.kv_rows("a", 0, 30))
    fired0 = faults_fired("fault.wal_sync_failed")
    arm_fault_once("fault.wal_sync_failed")
    for i in range(30, 60, 6):
        cluster.write(cluster.kv_rows("a", i, 6))
    assert faults_fired("fault.wal_sync_failed") == fired0 + 1

    payload = {"client_id": "client-1", "request_id": 4242}
    r1 = cluster.write(cluster.kv_rows("dup", 999, 1), **payload)

    leader = cluster.leader()
    cluster.stop(leader)
    ts = cluster.start(leader)

    def replayed():
        try:
            peer = ts.tablet_manager.get(TID)
            res = peer.tablet.engine.scan(T.ScanSpec(projection=["k"]))
        except Exception:  # noqa: BLE001 — still opening
            return False
        return len(res.rows) == 61
    wait_for(replayed, timeout=60.0, msg="bootstrap WAL replay")

    r2 = cluster.write(cluster.kv_rows("dup", 999, 1), **payload)
    assert r2["ht"] == r1["ht"], \
        "replayed RetryableRequests must return the original ht"
    rows = cluster.all_rows(("k", "v"))
    assert len(rows) == 61
    assert sum(1 for row in rows if row[0] == "dup999") == 1


def test_install_snapshot_term_fencing(cluster):
    """A payload from an older term than the replica's is ignored (a stale
    ex-leader must not destroy a healthy replica); one of the present term
    replaces the replica, which then serves the same rows."""
    cluster.write(cluster.kv_rows("a", 0, 40))
    leader = cluster.leader()
    resp = cluster.call(leader, "ts.rb_snapshot", {"tablet_id": TID})
    assert resp["code"] == "ok"
    payload = resp["payload"]
    victim = next(u for u in NODES if u != leader)
    mgr = cluster.servers[victim].tablet_manager
    before = mgr.get(TID)
    term = before.raft.cmeta.current_term
    assert payload["term"] == term
    mgr.install_snapshot(TID, dict(payload, term=term - 1))
    assert mgr.bootstrap_installs == 0 and mgr.get(TID) is before
    mgr.install_snapshot(TID, payload)
    assert mgr.bootstrap_installs == 1 and mgr.get(TID) is not before
    peer = mgr.get(TID)
    wait_for(lambda: len(peer.tablet.engine.scan(
        T.ScanSpec(projection=["k"])).rows) == 40, msg="installed rows")


def test_mesh_scans_answer_ineligible(cluster):
    """The mesh scan service on one server's tablet (a 1x1 mesh of the
    CPU): once the leader's tablet holds one run and no memtable key, an
    eligible ``count(*)`` through ``ts.multi_agg_scan`` answers "ok" with
    the leader's count (``served``); a string ``max`` answers the JAX
    service's ``{"code": "ineligible"}``, counted in ``fallbacks``."""
    cluster.write(cluster.kv_rows("m", 0, 10))
    leader = cluster.leader()
    cluster.peer(leader).flush()
    service = cluster.servers[leader].mesh_scan

    def multi(aggs):
        return cluster.call(leader, "ts.multi_agg_scan", {
            "tablet_ids": [TID],
            "spec": t_wire.encode_spec(T.ScanSpec(aggregates=aggs))})

    resp = multi([T.AggSpec("count", None)])
    assert resp["code"] == "ok", resp
    assert t_wire.decode_result(resp).rows == [(10,)]
    want = cluster.scan(T.ScanSpec(aggregates=[T.AggSpec("count", None)]))
    assert t_wire.decode_result(want).rows == [(10,)]
    assert (service.served, service.fallbacks) == (1, 0)
    assert multi([T.AggSpec("max", "k")]) == {"code": "ineligible"}
    assert (service.served, service.fallbacks) == (1, 1)


def test_webserver_pages(cluster):
    """The tablet server's embedded webserver: /healthz from the port's
    breakers, /memz with the residency cache, the RPC counters on
    /metrics, the tablets' JSON."""
    import json
    import urllib.request

    cluster.write(cluster.kv_rows("w", 0, 5))
    leader = cluster.leader()
    host, port = cluster.servers[leader].start_webserver("127.0.0.1", 0)

    def get(path):
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=10) as r:
            return r.read().decode()
    assert json.loads(get("/healthz"))["status"] == "ok"
    memz = json.loads(get("/memz"))
    assert "hbm_cache" in memz and "plane_encoding" not in memz
    assert "rpc_requests_total" in get("/metrics")
    rows = json.loads(get("/tablets"))
    assert [r["tablet_id"] for r in rows] == [TID]
    assert rows[0]["role"] == "leader"


def test_server_flags_match_the_jax_flags():
    """The flag the tablet server reads: the JAX name, default, help text
    and tags."""
    from yugabyte_db_tpu.utils.flags import FLAGS as JFLAGS
    from yugabyte_db_tpu_torch.utils.flags import FLAGS

    port = {f.name: f for f in FLAGS.all()}
    jax = {f.name: f for f in JFLAGS.all()}
    n = "max_clock_skew_us"
    assert (port[n].default, port[n].help, port[n].tags) == \
        (jax[n].default, jax[n].help, jax[n].tags), n


def test_master_daemon_serves_a_tserver_daemon(tmp_path):
    """``daemon_main --role master`` and ``--role tserver --device cpu`` in
    two processes: the tserver registers by heartbeat, and a ``YBClient``
    over the port's ``SocketTransport`` creates a table, writes a row
    through ``YBSession`` and reads it back."""
    from yugabyte_db_tpu_torch.client import YBClient, YBSession
    from yugabyte_db_tpu_torch.rpc import SocketTransport

    roles = {"m-0": "master", "ts-0": "tserver"}
    uuids = list(roles)
    ports = free_ports(len(uuids))
    topo = ",".join(f"{u}=127.0.0.1:{p}" for u, p in zip(uuids, ports))
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {u: subprocess.Popen(
        [sys.executable, "-m", "yugabyte_db_tpu_torch.server.daemon_main",
         "--role", roles[u], "--device", "cpu", "--uuid", u,
         "--data-dir", str(tmp_path / u), "--topology", topo,
         "--masters", "m-0", "--no-fsync"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for u in uuids}
    transport = SocketTransport()
    for u, p in zip(uuids, ports):
        transport.set_address(u, "127.0.0.1", p)
    try:
        client = YBClient(transport, ["m-0"])

        def registered():
            for p in procs.values():
                assert p.poll() is None, p.communicate()
            try:
                resp = client.master_rpc("master.list_tservers", {},
                                         timeout_s=5.0)
            except Exception:  # noqa: BLE001 — the master is starting
                return False
            return [t["uuid"] for t in resp["tservers"]] == ["ts-0"]
        wait_for(registered, timeout=90.0, interval=0.2,
                 msg="the tserver's registration")
        table = client.create_table("kv", [
            t_schema.ColumnSchema("k", t_dt.DataType.STRING,
                                  t_schema.ColumnKind.HASH),
            t_schema.ColumnSchema("v", t_dt.DataType.INT64)],
            num_tablets=1, replication_factor=1)
        assert table.engine == "gpu"
        session = YBSession(client)
        session.insert(table, {"k": "a", "v": 7})
        assert session.flush() == 1
        assert session.get(table, {"k": "a"}) == ("a", 7)
    finally:
        transport.close()
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = {u: p.wait(timeout=60) for u, p in procs.items()}
    assert codes == {u: 0 for u in uuids}, {
        u: p.stderr.read()[-2000:] for u, p in procs.items()}


# -- a JAX-vs-port differential over the RPC surface -----------------------

def bench_rows(side, schema, seed=3):
    """Batches of bench-table rows (inserts, one-field updates, deletes):
    the same values in both packages for one seed."""
    import random

    rng = random.Random(seed)
    RV = side.S.RowVersion
    cid = {c.name: c.col_id for c in schema.columns}

    def kf(i):
        return schema.encode_primary_key(
            {"k": f"user{i:04d}", "r": i % 3},
            side.partition.compute_hash_code(schema, {"k": f"user{i:04d}"}))
    out = []
    for b in range(5):
        out.append([RV(kf(b * 40 + j), ht=0, liveness=True, columns={
            cid["a"]: rng.randrange(-10**12, 10**12),
            cid["c"]: rng.choice([0.5, -1.25, 3.0, None]),
            cid["d"]: rng.randrange(-10**6, 10**6)}) for j in range(40)])
    for _ in range(3):
        batch = []
        for _ in range(25):
            i = rng.randrange(200)
            roll = rng.random()
            if roll < 0.15:
                batch.append(RV(kf(i), ht=0, tombstone=True))
            else:
                batch.append(RV(kf(i), ht=0, columns={
                    cid["d"]: rng.randrange(-10**6, 10**6)}))
        out.append(batch)
    return out, kf


def stripped(resp: dict) -> dict:
    """A reply without its hybrid times and uuids."""
    return {k: v for k, v in resp.items()
            if k not in ("ht", "read_ht", "uuid")}


def step_label(step) -> str:
    """The label ``diff_script`` gave a step: a write's reply is a bare
    dict, every other step a tuple that starts with its labels."""
    if isinstance(step, dict):
        return "write"
    return " ".join(str(x) for x in step[:-1])


def diff_script(c: Cluster) -> list:
    """One package's replies to the RPC script, hybrid times and uuids
    left out."""
    side, S = c.side, c.side.S
    out = []
    batches, kf = bench_rows(side, c.schema)
    c.create()
    # A write and its duplicate: the same reply, hybrid time included.
    ids = {"client_id": "client-9", "request_id": 1}
    r1 = c.write(batches[0], **ids)
    r2 = c.write(batches[0], **ids)
    assert r1 == r2
    out.append(stripped(r1))
    for b in batches[1:]:
        out.append(stripped(c.write(b)))

    def specs():
        heads = [S.ScanSpec(predicates=[S.Predicate("d", ">=", lo)],
                            aggregates=[S.AggSpec("count", None),
                                        S.AggSpec("sum", "a"),
                                        S.AggSpec("min", "a"),
                                        S.AggSpec("max", "d")])
                 for lo in (-10**6, 0, 500_000)]
        grouped = S.ScanSpec(aggregates=[S.AggSpec("count", None),
                                         S.AggSpec("sum", "a")],
                             group_by=["r"])
        return [side.wire.encode_spec(s) for s in heads + [grouped]]

    pages = [side.wire.encode_spec(S.ScanSpec(
        lower=kf(i), predicates=[S.Predicate("d", ">=", -500_000)],
        projection=["k", "r", "a", "d"], limit=20)) for i in (0, 17, 133)]

    def reads(label):
        scan = c.on_leader("ts.scan", {"spec": side.wire.encode_spec(
            S.ScanSpec(projection=["k", "r", "a", "c", "d"], limit=60))})
        out.append((label, "scan", stripped(scan)))
        batch = c.on_leader("ts.scan_batch", {"specs": specs()})
        out.append((label, "scan_batch", stripped(batch)))
        for fmt in ("cql", "pg"):
            wb = c.on_leader("ts.scan_wire_batch",
                             {"specs": pages, "fmt": fmt})
            out.append((label, fmt, stripped(wb)))
    reads("memtable")
    # Flushes and compactions are local to a replica, and a scan's
    # ``rows_scanned`` follows the runs of the replica that serves it: each
    # replica applies every entry, then flushes or compacts, so that a
    # leader change between two steps changes no reply.
    c.settle()
    for uuid in NODES:
        out.append(("flush", c.call(uuid, "ts.flush", {"tablet_id": TID})))
    reads("flushed")
    new_schema = c.schema.with_added_column("e", side.dt.DataType.INT64)
    out.append(("alter", c.on_leader("ts.alter_schema",
                                     {"schema": new_schema.to_dict()})))
    c.schema = new_schema
    scan = c.on_leader("ts.scan", {"spec": side.wire.encode_spec(
        S.ScanSpec(projection=["k", "a", "e"], limit=30))})
    out.append(("altered", stripped(scan)))
    out.append(("snapshot", c.on_leader(
        "ts.snapshot_op", {"op": "create_snapshot", "snapshot_id": "s1"})))
    out.append(("list", c.on_leader("ts.list_snapshots", {})))
    # A transaction's intents, applied.
    cid = {col.name: col.col_id for col in c.schema.columns}
    txn_rows = [side.S.RowVersion(kf(500 + i), ht=0, liveness=True,
                                  columns={cid["a"]: i, cid["d"]: i})
                for i in range(3)]
    lead = c.peer(c.leader())
    wi = c.on_leader("ts.write_intents", {
        "txn_id": "txn-1", "status_tablet": "status-0", "priority": 5,
        "read_ht": lead.tablet.clock.now().value,
        "rows": side.wire.encode_rows(txn_rows)})
    out.append(("write_intents", stripped(wi)))
    out.append(("apply_txn", c.on_leader(
        "ts.apply_txn", {"txn_id": "txn-1", "commit_ht": wi["ht"] + 1})))
    reads("txn")
    c.settle()
    for uuid in NODES:
        out.append(("compact", c.call(uuid, "ts.compact", {
            "tablet_id": TID, "history_cutoff_ht": 0})))
    reads("compacted")
    out.append(("split_key", c.on_leader("ts.get_split_key", {})))
    out.append(("checksum", stripped(c.on_leader("ts.checksum", {}))))
    status = {u: c.call(u, "ts.status", {}) for u in NODES}
    out.append(("status", sorted(
        (list(s["tablets"]), s["tablets"][TID]["raft"]["config"])
        for s in status.values())))
    return out


def test_port_tservers_answer_as_the_jax_tservers(tmp_path):
    with D.plain_planes():
        jc = Cluster(tmp_path / "jax", JAXSIDE, bench_schema(JAXSIDE),
                     engine="tpu")
        try:
            want = diff_script(jc)
        finally:
            jc.shutdown()
        tc = Cluster(tmp_path / "port", PORTSIDE, bench_schema(PORTSIDE))
        try:
            got = diff_script(tc)
            assert tc.peer(tc.leader()).tablet.meta.engine == "gpu"
        finally:
            tc.shutdown()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (
            f"step {i} ({step_label(w)}) differs\n port: {g!r}\n"
            f" jax:  {w!r}\n retries: port {tc.retried}, jax {jc.retried}")


def compaction_then_transfer(c: Cluster) -> list:
    """A limit scan's reply on a leader that alone compacted its runs,
    then on a replica that did not, after a leadership transfer."""
    batches, _kf = bench_rows(c.side, c.schema)
    c.create()
    for layer in (batches, batches[5:]):  # two runs on every replica
        for b in layer:
            c.write(b)
        c.settle()
        for uuid in NODES:
            c.call(uuid, "ts.flush", {"tablet_id": TID})
    spec = c.side.wire.encode_spec(c.side.S.ScanSpec(
        projection=["k", "r", "a", "c", "d"], limit=60))
    lead = c.leader()
    assert c.call(lead, "ts.compact", {"tablet_id": TID,
                                       "history_cutoff_ht": 0}) == \
        {"code": "ok"}
    out = [stripped(c.on_leader("ts.scan", {"spec": spec}))]
    other = next(u for u in NODES if u != lead)

    def moved():
        st = c.call(other, "ts.status", {})["tablets"][TID]["raft"]
        if st["role"] == "LEADER":
            return True
        c.call(lead, "ts.transfer_leadership",
               {"tablet_id": TID, "target": other})
        return False
    wait_for(moved, msg="the transfer")
    out.append(stripped(c.on_leader("ts.scan", {"spec": spec})))
    return out


def test_a_leader_local_compaction_shows_in_both_packages(tmp_path):
    """What made the differential above flaky on a loaded host: a
    compaction is local to one replica, and ``rows_scanned`` follows the
    runs of the replica that serves the scan. The same state gives the
    same replies in both packages; the replies differ only between
    replicas of different runs, so the script settles and compacts every
    replica."""
    with D.plain_planes():
        jc = Cluster(tmp_path / "jax", JAXSIDE, bench_schema(JAXSIDE),
                     engine="tpu")
        try:
            want = compaction_then_transfer(jc)
        finally:
            jc.shutdown()
        tc = Cluster(tmp_path / "port", PORTSIDE, bench_schema(PORTSIDE))
        try:
            got = compaction_then_transfer(tc)
        finally:
            tc.shutdown()
    assert got == want
    compacted, uncompacted = got
    assert compacted["rows"] == uncompacted["rows"]
    assert compacted["rows_scanned"] != uncompacted["rows_scanned"]


# -- a JAX remote-bootstrap payload installed by the port ------------------

def tree_bytes(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_install_of_a_jax_payload_equals_the_jax_install(tmp_path,
                                                         monkeypatch):
    """``ts.rb_snapshot`` of a JAX tablet server (runs, a snapshot,
    pending intents, the dedup registry, a WAL tail, the consensus
    metadata), installed by a JAX and by a port ``TSTabletManager``: the
    two directories are equal byte for byte, and the port's replica
    serves the JAX leader's rows."""
    from yugabyte_db_tpu.storage import engine as j_engine

    # The payload names the engine its tablet ran on; the port opens a
    # "gpu" tablet, so the JAX source runs its cpu engine under that name.
    monkeypatch.setitem(j_engine._ENGINES, "gpu",
                        j_engine._ENGINES["cpu"])
    src = Cluster(tmp_path / "src", JAXSIDE, bench_schema(JAXSIDE),
                  engine="gpu")
    try:
        batches, kf = bench_rows(JAXSIDE, src.schema, seed=5)
        src.create()
        for i, b in enumerate(batches):
            src.write(b, client_id="client-3", request_id=i + 1)
        src.on_leader("ts.snapshot_op", {"op": "create_snapshot",
                                         "snapshot_id": "s1"})
        want = src.all_rows(("k", "r", "a", "c", "d"))
        cid = {c.name: c.col_id for c in src.schema.columns}
        src.on_leader("ts.write_intents", {
            "txn_id": "txn-7", "status_tablet": "status-0", "priority": 3,
            "read_ht": src.peer(src.leader()).tablet.clock.now().value,
            "rows": j_wire.encode_rows([J.RowVersion(
                kf(900), ht=0, liveness=True, columns={cid["a"]: 1})])})
        resp = src.on_leader("ts.rb_snapshot", {})
        assert resp["code"] == "ok"
    finally:
        src.shutdown()
    payload = resp["payload"]
    assert payload["runs"] and payload["snapshots"] and payload["intents"]
    assert payload["engine"] == "gpu"

    started = {}
    mgrs = {"jax": j_tm.TSTabletManager("ts-0", str(tmp_path / "jax"),
                                        JC.LocalTransport(), fsync=False),
            "port": t_tm.TSTabletManager("ts-0", str(tmp_path / "port"),
                                         TC.LocalTransport(), fsync=False,
                                         engine_options={"device": "cpu"})}
    for name, mgr in mgrs.items():
        mgr._start_peer = (lambda meta, initial_peers, _n=name:
                           started.setdefault(_n, meta))
        mgr.install_snapshot(TID, payload)
        assert mgr.bootstrap_installs == 1 and name in started
    jtree = tree_bytes(tmp_path / "jax" / "tablet-data" / TID)
    ttree = tree_bytes(tmp_path / "port" / "tablet-data" / TID)
    assert sorted(ttree) == sorted(jtree)
    for name in ("tablet-meta.json", "consensus-meta.json", "intents.bin",
                 "retryable.bin"):
        assert name in ttree
    assert any(n.startswith("runs" + os.sep) for n in ttree)
    assert any(n.startswith("wal" + os.sep) for n in ttree)
    for name in jtree:
        assert ttree[name] == jtree[name], name

    # The port's replica, started on the installed directory (a follower
    # of the source's group, whose leader is gone), holds the same rows.
    mgr = mgrs["port"]
    peer = t_tm.TSTabletManager._start_peer(mgr, started["port"], [])
    try:
        res = peer.tablet.engine.scan(
            T.ScanSpec(projection=["k", "r", "a", "c", "d"]))
        assert [tuple(r) for r in res.rows] == want
        assert peer.tablet.participant.has_intents("txn-7")
    finally:
        mgr.shutdown()


# -- three daemon processes over loopback ----------------------------------

def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_three_daemon_processes_serve_a_tablet(tmp_path):
    from yugabyte_db_tpu_torch.rpc import SocketTransport, TransportError

    ports = free_ports(len(NODES))
    topo = ",".join(f"{u}=127.0.0.1:{p}" for u, p in zip(NODES, ports))
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {u: subprocess.Popen(
        [sys.executable, "-m", "yugabyte_db_tpu_torch.server.daemon_main",
         "--role", "tserver", "--device", "cpu", "--uuid", u,
         "--data-dir", str(tmp_path / u), "--topology", topo,
         "--masters", "m-0", "--no-fsync"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for u in NODES}
    transport = SocketTransport()
    for u, p in zip(NODES, ports):
        transport.set_address(u, "127.0.0.1", p)
    try:
        def up(u):
            try:
                return transport.send(u, "ts.status", {}, 60.0)["uuid"] == u
            except TransportError:
                assert procs[u].poll() is None, procs[u].communicate()
                return False
        for u in NODES:
            wait_for(lambda u=u: up(u), timeout=60.0, interval=0.1,
                     msg=f"daemon {u}")
        schema = kv_schema(PORTSIDE)
        for u in NODES:
            assert transport.send(u, "ts.create_tablet", {
                "tablet_id": TID, "table_name": "t",
                "schema": schema.to_dict(), "partition_start": 0,
                "partition_end": 65536, "peers": NODES}, 60.0) == \
                {"code": "ok"}
        cid = {c.name: c.col_id for c in schema.columns}
        rows = [T.RowVersion(schema.encode_primary_key(
            {"k": f"p{i}"}, t_partition.compute_hash_code(
                schema, {"k": f"p{i}"})), ht=0, liveness=True,
            columns={cid["v"]: i}) for i in range(25)]

        def rpc_leader(method, payload):
            for u in NODES:
                st = transport.send(u, "ts.status", {}, 60.0)["tablets"]
                if st.get(TID, {}).get("raft", {}).get("role") == "LEADER":
                    resp = transport.send(u, method, dict(
                        payload, tablet_id=TID, timeout=60.0), 60.0)
                    if resp.get("code") == "ok":
                        return resp
            return None
        wrote = wait_for(lambda: rpc_leader(
            "ts.write", {"rows": t_wire.encode_rows(rows),
                         "client_id": "c", "request_id": 1}),
            timeout=60.0, interval=0.1, msg="a write through the leader")
        assert wrote["code"] == "ok"
        res = wait_for(lambda: rpc_leader("ts.scan", {
            "spec": t_wire.encode_spec(T.ScanSpec(projection=["k", "v"]))}),
            timeout=30.0, interval=0.1, msg="a scan")
        assert sorted(tuple(r) for r in res["rows"]) == \
            sorted((f"p{i}", i) for i in range(25))
    finally:
        transport.close()
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = {u: p.wait(timeout=60) for u, p in procs.items()}
    assert codes == {u: 0 for u in NODES}, {
        u: p.stderr.read()[-2000:] for u, p in procs.items()}
