"""The port's master (``yugabyte_db_tpu_torch/master``) against the JAX
package's, on its files.

- The same DDL (tables, an ALTER, an index, roles and a grant, a DROP) on
  a JAX master and on a port master writes the same sys catalog, byte for
  byte: every WAL segment and ``consensus-meta.json``. Both masters run
  with a standing hybrid clock and the same sequence of uuids, so the
  entries' hybrid times and the table ids agree instead of being masked.
- A port master restarted on the directory a JAX master wrote serves the
  same catalog: the tables, their tablets and replicas, and the roles.

Each master is a one-master group over a ``LocalTransport``; three
tablet servers answer it with ``{"code": "ok"}`` and report by heartbeat,
so placement has live tservers and the DDL's pushes land.
"""

from __future__ import annotations

import os
import shutil
import time
import uuid
from types import SimpleNamespace

import yugabyte_db_tpu.auth as j_auth
import yugabyte_db_tpu.consensus.transport as j_transport
import yugabyte_db_tpu.master.master as j_master
import yugabyte_db_tpu.models.datatypes as j_dt
import yugabyte_db_tpu.models.schema as j_schema
import yugabyte_db_tpu.utils.hybrid_time as j_ht
import yugabyte_db_tpu_torch.auth as t_auth
import yugabyte_db_tpu_torch.consensus.transport as t_transport
import yugabyte_db_tpu_torch.master.master as t_master
import yugabyte_db_tpu_torch.models.datatypes as t_dt
import yugabyte_db_tpu_torch.models.schema as t_schema
import yugabyte_db_tpu_torch.utils.hybrid_time as t_ht

JAXSIDE = SimpleNamespace(name="jax", master=j_master, auth=j_auth,
                          transport=j_transport, dt=j_dt, schema=j_schema,
                          ht=j_ht)
PORTSIDE = SimpleNamespace(name="port", master=t_master, auth=t_auth,
                           transport=t_transport, dt=t_dt, schema=t_schema,
                           ht=t_ht)

CLOCK_US = 1_700_000_000_000_000
TSERVERS = ["ts-0", "ts-1", "ts-2"]
SALTED = t_auth.hash_password("pw")  # one salt, so both logs hold it
# The balancer loop ticks (and shutdown joins it promptly), but no
# tserver goes dead and no replica counts as missing within a test.
QUIET = {"balance_interval_s": 0.2, "ts_unresponsive_timeout_s": 3600.0,
         "missing_replica_grace_s": 3600.0}


def wait_for(pred, timeout=30.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def start_master(side, root, monkeypatch):
    """A one-master group on ``root`` with a standing clock, uuids counted
    from 1, and three tablet servers that answer every RPC with ok."""
    ids = iter(range(1, 1 << 20))  # in the high bits: ids are hex[:16]
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(ids) << 64))
    monkeypatch.setattr(side.master, "HybridClock",
                        lambda: side.ht.HybridClock(
                            now_micros=lambda: CLOCK_US))
    transport = side.transport.LocalTransport()
    for ts in TSERVERS:
        transport.register(ts, lambda method, payload: {"code": "ok"})
    m = side.master.Master("m-0", str(root), transport.bind("m-0"), ["m-0"],
                           fsync=False, **QUIET)
    transport.register("m-0", m.handle)
    m.start()
    wait_for(lambda: m.is_leader() and m.raft.leader_ready(),
             msg=f"{side.name} master leadership")
    for ts in TSERVERS:
        assert m.handle("master.ts_heartbeat", {
            "ts_uuid": ts, "num_live_tablets": 0,
            "tablets": []})["code"] == "ok"
    return m


def ddl(side, m) -> list:
    """The DDL script; the master's replies."""
    S, DT = side.schema, side.dt.DataType
    schema = S.Schema([S.ColumnSchema("k", DT.STRING, S.ColumnKind.HASH),
                       S.ColumnSchema("r", DT.INT64, S.ColumnKind.RANGE),
                       S.ColumnSchema("v", DT.INT64),
                       S.ColumnSchema("s", DT.STRING)], table_id="kv")
    out = []
    for name, n in (("kv", 4), ("other", 1)):
        out.append(m.handle("master.create_table", {
            "name": name, "schema": schema.to_dict(), "num_tablets": n,
            "replication_factor": 3, "engine": "gpu"}))
    out.append(m.handle("master.alter_table", {
        "name": "kv",
        "schema": schema.with_added_column("e", DT.INT64).to_dict()}))
    out.append(m.handle("master.create_index", {"table": "kv",
                                                "columns": ["v"]}))
    out.append(m.handle("master.auth_op", {"auth": {
        "op": "auth_create_role", "name": "admin", "superuser": True,
        "can_login": True, "salted_hash": SALTED}}))
    out.append(m.handle("master.auth_op", {"auth": {
        "op": "auth_grant_perm", "role": "admin", "resource": "data/ks",
        "perm": "SELECT"}}))
    out.append(m.handle("master.delete_table", {"name": "other"}))
    return out


def served(m) -> dict:
    """What the master serves of its catalog."""
    tables = m.handle("master.list_tables", {})
    out = {"tables": tables, "auth": m.handle("master.get_auth", {})}
    for t in tables["tables"]:
        out[t["name"]] = (m.handle("master.get_table", {"name": t["name"]}),
                          m.handle("master.get_table_locations",
                                   {"name": t["name"]}))
    return out


def sys_catalog(root) -> dict:
    top = os.path.join(str(root), "sys-catalog")
    out = {}
    for d, _dirs, files in os.walk(top):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = fh.read()
    return out


def run(side, root, monkeypatch) -> tuple:
    m = start_master(side, root, monkeypatch)
    try:
        replies = ddl(side, m)
        catalog = served(m)
    finally:
        m.shutdown()
    return replies, catalog


def test_same_ddl_writes_the_same_sys_catalog(tmp_path, monkeypatch):
    want_replies, want_catalog = run(JAXSIDE, tmp_path / "jax", monkeypatch)
    got_replies, got_catalog = run(PORTSIDE, tmp_path / "port", monkeypatch)
    assert [r["code"] for r in want_replies] == ["ok"] * 7
    assert got_replies == want_replies
    assert got_catalog == want_catalog
    want, got = sys_catalog(tmp_path / "jax"), sys_catalog(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert any(name.startswith("wal") for name in want), sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_port_master_serves_a_catalog_the_jax_master_wrote(tmp_path,
                                                           monkeypatch):
    _replies, want = run(JAXSIDE, tmp_path / "jax", monkeypatch)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.undo()  # the port master keeps the real clock and uuids
    transport = t_transport.LocalTransport()
    m = t_master.Master("m-0", str(tmp_path / "port"),
                        transport.bind("m-0"), ["m-0"], fsync=False, **QUIET)
    transport.register("m-0", m.handle)
    m.start()
    try:
        wait_for(lambda: m.is_leader() and m.raft.leader_ready(),
                 msg="the port master's leadership")
        got = served(m)
    finally:
        m.shutdown()
    assert got == want
    assert sorted(t["name"] for t in got["tables"]["tables"]) == \
        ["kv", "kv__idx__v"]
    assert got["auth"]["auth"]["roles"]
    store = t_auth.RoleStore.from_dict(got["auth"]["auth"])
    assert store.check_login("admin", "pw")
    assert store.authorize("admin", "SELECT", "data/ks/t")
