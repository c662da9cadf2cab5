"""A client-level differential: the JAX package's ``MiniCluster`` (the
``tpu`` engine on JAX's CPU backend) and the port's (the ``gpu`` engine on
CPU tensors) take the same script through their own ``YBClient``,
``YBSession`` and ``TransactionManager``, and give the same answers.

The script creates a four-tablet RF-3 table, writes and updates it
through the session, reads it (a full scan, point gets, aggregates, a
GROUP BY and a LIMIT page), splits a tablet through the master and reads
across the children, commits one transaction and aborts another, adds a
column, takes a master-coordinated snapshot and restores it, and restarts
the cluster. Each step's answer is held equal: rows, columns and
integer, count, min and max results exactly, the DOUBLE column's sums to
``tests/test_engine_diff.py``'s tolerance. Hybrid times, uuids, table and
tablet ids, and ``rows_scanned`` (the versions the serving replicas read,
which follows each replica's runs, not the answer) are left out. A
failure names the step.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_data as D
import yugabyte_db_tpu.client as j_client
import yugabyte_db_tpu.integration as j_integration
import yugabyte_db_tpu.models.datatypes as j_dt
import yugabyte_db_tpu.models.schema as j_schema
import yugabyte_db_tpu.storage.scan_spec as j_spec
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.client as t_client
import yugabyte_db_tpu_torch.models.datatypes as t_dt
import yugabyte_db_tpu_torch.models.schema as t_schema
import yugabyte_db_tpu_torch.storage.scan_spec as t_spec

JAXSIDE = SimpleNamespace(
    name="jax", engine="tpu", client=j_client, dt=j_dt, schema=j_schema,
    spec=j_spec,
    cluster=lambda root: j_integration.MiniCluster(root, num_tservers=3))
PORTSIDE = SimpleNamespace(
    name="port", engine="gpu", client=t_client, dt=t_dt, schema=t_schema,
    spec=t_spec, cluster=lambda root: D.cpu_mini_cluster(root,
                                                         num_tservers=3))

NKEYS = 240


def columns(side):
    S, DT = side.schema, side.dt.DataType
    return [S.ColumnSchema("k", DT.STRING, S.ColumnKind.HASH),
            S.ColumnSchema("r", DT.INT64, S.ColumnKind.RANGE),
            S.ColumnSchema("a", DT.INT64),
            S.ColumnSchema("c", DT.DOUBLE),
            S.ColumnSchema("d", DT.INT32)]


def workload(seed=5):
    """Inserts, one-field updates and deletes, made from ``seed``: plain
    Python values, the same for both sides."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-10**12, 10**12, NKEYS)
    c = rng.choice([0.5, -1.25, 3.0, 1e6, np.nan], NKEYS)
    d = rng.integers(-10**6, 10**6, NKEYS)
    inserts = [{"k": f"user{i:04d}", "r": i % 3, "a": int(a[i]),
                "c": None if np.isnan(c[i]) else float(c[i]),
                "d": int(d[i])} for i in range(NKEYS)]
    updates = [({"k": f"user{i:04d}", "r": i % 3},
                {"d": int(rng.integers(-10**6, 10**6))})
               for i in rng.choice(NKEYS, 60, replace=False)]
    deletes = [{"k": f"user{i:04d}", "r": i % 3}
               for i in rng.choice(NKEYS, 20, replace=False)]
    return inserts, updates, deletes


def wait_for(pred, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def answer(res) -> dict:
    """A ``ScanResult`` less what is not the answer."""
    return {"columns": list(res.columns),
            "rows": [tuple(r) for r in res.rows]}


def reads(side, session, table, label, out, extra=()):
    S = side.spec
    proj = ["k", "r", "a", "c", "d", *extra]
    out.append((f"{label} scan", answer(session.scan(
        table, S.ScanSpec(projection=proj)))))
    out.append((f"{label} gets", [session.get(table, {"k": f"user{i:04d}",
                                                      "r": i % 3})
                                  for i in (0, 7, 100, 239, 500)]))
    for lo in (-10**6, 0, 500_000):
        out.append((f"{label} aggregate d >= {lo}", answer(session.scan(
            table, S.ScanSpec(
                predicates=[S.Predicate("d", ">=", lo)],
                aggregates=[S.AggSpec("count", None), S.AggSpec("sum", "a"),
                            S.AggSpec("min", "a"), S.AggSpec("max", "d"),
                            S.AggSpec("count", "c"),
                            S.AggSpec("sum", "c")])))))
    out.append((f"{label} group by", answer(session.scan(table, S.ScanSpec(
        aggregates=[S.AggSpec("count", None), S.AggSpec("sum", "a"),
                    S.AggSpec("min", "d")], group_by=["r"])))))
    out.append((f"{label} page", answer(session.scan(table, S.ScanSpec(
        predicates=[S.Predicate("d", ">=", -500_000)],
        projection=["k", "r", "a", "d"], limit=25)))))


def client_script(side, root) -> list:
    """One package's answers to the script, as (step label, answer)."""
    C = side.client
    inserts, updates, deletes = workload()
    out = []
    mc = side.cluster(str(root)).start()
    try:
        mc.wait_tservers_registered()
        client = mc.client()
        table = client.create_table("bench", columns(side), num_tablets=4,
                                    replication_factor=3,
                                    engine=side.engine)
        out.append(("create", (table.engine == side.engine, len(
            client.meta_cache.locations("bench").tablets))))
        s = C.YBSession(client)
        for row in inserts:
            s.insert(table, row)
        out.append(("write", s.flush()))
        for key, values in updates:
            s.update(table, key, values)
        for key in deletes:
            s.delete(table, key)
        out.append(("update", s.flush()))
        reads(side, s, table, "written", out)
        # A split through the master; the reads cross both children.
        locs = client.meta_cache.locations("bench", refresh=True)
        resp = client.master_rpc("master.split_tablet", {
            "table": "bench", "tablet_id": locs.tablets[0].tablet_id,
            "timeout": 30.0}, timeout_s=40.0)
        out.append(("split", (resp["code"], len(resp["children"]))))
        out.append(("tablets after the split", len(
            client.meta_cache.locations("bench", refresh=True).tablets)))
        reads(side, s, table, "split", out)
        # A transaction committed, another aborted.
        mgr = C.TransactionManager(client)
        txn = mgr.begin()
        for i in range(3):
            txn.insert(table, {"k": f"txn{i}", "r": 1, "a": i, "c": 2.5,
                               "d": i})
        txn.update(table, {"k": "user0007", "r": 1}, {"a": -7})
        out.append(("commit", txn.commit() > 0))
        aborted = mgr.begin()
        aborted.insert(table, {"k": "ghost", "r": 0, "a": 1, "d": 1})
        aborted.flush()
        aborted.abort()
        reads(side, s, table, "transactions", out)
        # ALTER: a column added; old rows read it as NULL.
        new = table.schema.with_added_column("e", side.dt.DataType.INT64)
        client.alter_table("bench", new.to_dict())
        table = client.open_table("bench")
        s.insert(table, {"k": "altered", "r": 2, "a": 5, "d": 5, "e": 9})
        s.flush()
        reads(side, s, table, "altered", out, extra=("e",))
        # A master-coordinated snapshot, a divergence, the restore.
        snap = client.master_rpc("master.snapshot_op", {
            "action": "create", "table": "bench", "snapshot_id": "cs1"})
        out.append(("snapshot", (snap["code"], snap["tablets"])))
        s.insert(table, {"k": "diverged", "r": 0, "a": 1, "d": 1, "e": 1})
        s.delete(table, {"k": "user0100", "r": 1})
        s.flush()
        restore = client.master_rpc("master.snapshot_op", {
            "action": "restore", "snapshot_id": "cs1"})
        out.append(("restore", restore["code"]))
        reads(side, s, table, "restored", out, extra=("e",))
    finally:
        mc.shutdown()
    # The whole cluster restarts on its directories.
    mc = side.cluster(str(root)).start()
    try:
        mc.wait_tservers_registered()
        client = mc.client("after-restart")
        table = client.open_table("bench")
        s = C.YBSession(client)
        wait_for(lambda: _serves(s, table, side), msg=f"{side.name} restart")
        reads(side, s, table, "restarted", out, extra=("e",))
    finally:
        mc.shutdown()
    return out


def _serves(session, table, side) -> bool:
    try:
        session.scan(table, side.spec.ScanSpec(limit=1))
        return True
    except Exception:  # noqa: BLE001 — tablets still electing
        return False


def same_answer(got, want, label):
    """Exact, but for the DOUBLE column's sums (``sum(c)``), which match to
    ``tests/test_engine_diff.py``'s tolerance."""
    if not (isinstance(want, dict) and "sum(c)" in want["columns"]):
        assert got == want, (
            f"step {label!r} differs\n port: {got!r}\n jax:  {want!r}")
        return
    assert got["columns"] == want["columns"], label
    i = want["columns"].index("sum(c)")
    assert len(got["rows"]) == len(want["rows"]), label
    for g, w in zip(got["rows"], want["rows"]):
        assert g[:i] + g[i + 1:] == w[:i] + w[i + 1:], (
            f"step {label!r} differs\n port: {g!r}\n jax:  {w!r}")
        assert g[i] == pytest.approx(w[i], rel=1e-4, abs=1e-4), (
            f"step {label!r}: sum(c) {g[i]!r} against {w[i]!r}")


def test_port_cluster_answers_as_the_jax_cluster(tmp_path):
    with D.plain_planes():
        want = client_script(JAXSIDE, tmp_path / "jax")
        got = client_script(PORTSIDE, tmp_path / "port")
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, g), (_label, w) in zip(got, want):
        same_answer(g, w, label)
