"""Distributed transactions on the port's cluster, under the assertions of
the JAX package's ``tests/test_txn.py``: atomic multi-tablet commit,
snapshot isolation, conflict resolution, abort and expiry cleanup, and
restart recovery. The tablets run on the ``gpu`` engine over CPU tensors.
"""

import random
import threading
import time

import pytest

from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.client import YBSession
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema
from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec
from yugabyte_db_tpu_torch.txn import (TransactionConflict, TransactionManager,
                                 YBTransaction)

COLUMNS = [
    ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
    ColumnSchema("v", DataType.INT64),
]


def wait_for(pred, timeout=15.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r = pred()
        if r:
            return r
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture
def cluster(tmp_path):
    c = MiniCluster(str(tmp_path), num_masters=1, num_tservers=3).start()
    c.wait_tservers_registered()
    yield c
    c.shutdown()


def _scan_kv(client, table, read_ht=None):
    spec = ScanSpec(projection=["k", "v"])
    if read_ht is not None:
        spec.read_ht = read_ht
    res = YBSession(client).scan(table, spec)
    return dict(res.rows)


def test_commit_atomic_across_tablets(cluster):
    client = cluster.client()
    table = client.create_table("bank", COLUMNS, num_tablets=4)
    mgr = TransactionManager(client)
    txn = mgr.begin()
    for i in range(20):
        txn.insert(table, {"k": f"acct{i}", "v": 100})
    commit_ht = txn.commit()
    # At the commit time: every row visible (all-or-nothing).
    rows = _scan_kv(client, table, read_ht=commit_ht)
    assert rows == {f"acct{i}": 100 for i in range(20)}
    # Just before the commit time: none visible.
    assert _scan_kv(client, table, read_ht=commit_ht - 1) == {}


def test_abort_leaves_nothing(cluster):
    client = cluster.client()
    table = client.create_table("ab", COLUMNS, num_tablets=2)
    mgr = TransactionManager(client)
    txn = mgr.begin()
    txn.insert(table, {"k": "x", "v": 1})
    txn.insert(table, {"k": "y", "v": 2})
    txn.flush()
    txn.abort()
    # Intents are cleaned up on every participant.
    def intents_gone():
        for ts in cluster.tservers.values():
            for peer in ts.tablet_manager.peers():
                if peer.tablet.participant.has_intents(txn.txn_id):
                    return False
        return True
    wait_for(intents_gone, msg="intent cleanup after abort")
    assert _scan_kv(client, table) == {}


def test_read_your_writes(cluster):
    client = cluster.client()
    table = client.create_table("ryw", COLUMNS, num_tablets=2)
    s = YBSession(client)
    s.insert(table, {"k": "a", "v": 1})
    s.flush()
    mgr = TransactionManager(client)
    txn = mgr.begin()
    assert txn.get(table, {"k": "a"}) == ("a", 1)
    txn.update(table, {"k": "a"}, {"v": 5})
    assert txn.get(table, {"k": "a"}) == ("a", 5)   # buffered
    txn.flush()
    assert txn.get(table, {"k": "a"}) == ("a", 5)   # flushed intent
    txn.insert(table, {"k": "b", "v": 7})
    assert txn.get(table, {"k": "b"}) == ("b", 7)
    txn.delete_row(table, {"k": "a"})
    assert txn.get(table, {"k": "a"}) is None
    txn.abort()
    # Nothing leaked to committed state.
    assert _scan_kv(client, table) == {"a": 1}


def test_snapshot_isolation_first_committer_wins(cluster):
    client = cluster.client()
    table = client.create_table("si", COLUMNS, num_tablets=2)
    s = YBSession(client)
    s.insert(table, {"k": "c", "v": 1})
    s.flush()
    mgr = TransactionManager(client)
    txn = mgr.begin()  # snapshot taken now
    # A plain write lands after the txn's read point...
    s.update(table, {"k": "c"}, {"v": 2})
    s.flush()
    # ...so the txn's write to the same key must lose.
    txn.update(table, {"k": "c"}, {"v": 3})
    with pytest.raises(TransactionConflict):
        txn.flush()
    assert _scan_kv(client, table) == {"c": 2}


def test_pending_conflict_priority_duel(cluster):
    client = cluster.client()
    table = client.create_table("duel", COLUMNS, num_tablets=2)
    mgr = TransactionManager(client)
    t1 = mgr.begin()
    t2 = mgr.begin()
    t1.priority = 10
    t2.priority = 20
    t1.insert(table, {"k": "contested", "v": 1})
    t1.flush()
    # Higher priority wounds the pending lower-priority holder.
    t2.insert(table, {"k": "contested", "v": 2})
    t2.flush()
    assert t2.commit() > 0
    # t1 was wounded: its commit must fail.
    with pytest.raises(Exception):
        t1.commit()
    wait_for(lambda: _scan_kv(client, table) == {"contested": 2},
             msg="winner's write visible")


def test_lower_priority_writer_loses(cluster):
    client = cluster.client()
    table = client.create_table("duel2", COLUMNS, num_tablets=2)
    mgr = TransactionManager(client)
    t1 = mgr.begin()
    t2 = mgr.begin()
    t1.priority = 20
    t2.priority = 10
    t1.insert(table, {"k": "c2", "v": 1})
    t1.flush()
    t2.insert(table, {"k": "c2", "v": 2})
    with pytest.raises(TransactionConflict):
        t2.flush()
    assert t1.commit() > 0


def test_expired_txn_auto_aborts(cluster):
    client = cluster.client()
    table = client.create_table("exp", COLUMNS, num_tablets=2)
    mgr = TransactionManager(client)
    txn = mgr.begin()
    txn.insert(table, {"k": "zzz", "v": 9})
    txn.flush()
    # Shrink the expiry on every status-tablet coordinator.
    for ts in cluster.tservers.values():
        for peer in ts.tablet_manager.peers():
            if peer.tablet.coordinator is not None:
                peer.tablet.coordinator.expiry_s = 0.5
    # With no heartbeats the coordinator aborts it; a conflicting plain
    # write then cleans the intents and proceeds.
    s = YBSession(client)
    def plain_write_succeeds():
        try:
            s.insert(table, {"k": "zzz", "v": 10})
            s.flush()
            return True
        except Exception:
            return False
    wait_for(plain_write_succeeds, msg="expiry + wound of silent txn")
    assert _scan_kv(client, table)["zzz"] == 10


def test_concurrent_transfers_conserve_total(cluster):
    """Randomized concurrency: N threads transfer between accounts with
    retries; snapshot isolation must conserve the total balance."""
    client = cluster.client()
    table = client.create_table("xfer", COLUMNS, num_tablets=4)
    s = YBSession(client)
    NACCT = 8
    for i in range(NACCT):
        s.insert(table, {"k": f"a{i}", "v": 1000})
    s.flush()
    mgr = TransactionManager(client)
    stop = threading.Event()
    errors = []

    def worker(seed):
        rng = random.Random(seed)
        mine = attempts = 0
        while not stop.is_set() and mine < 8 and attempts < 80:
            attempts += 1
            i, j = rng.sample(range(NACCT), 2)
            amt = rng.randrange(1, 50)
            txn = mgr.begin()
            try:
                vi = txn.get(table, {"k": f"a{i}"})[1]
                vj = txn.get(table, {"k": f"a{j}"})[1]
                txn.update(table, {"k": f"a{i}"}, {"v": vi - amt})
                txn.update(table, {"k": f"a{j}"}, {"v": vj + amt})
                txn.commit()
                mine += 1
            except Exception as e:  # noqa: BLE001
                txn.abort()
                if not isinstance(e, TransactionConflict) and \
                        "conflict" not in str(e).lower() and \
                        "abort" not in str(e).lower():
                    errors.append(e)
                    return

    threads = [threading.Thread(target=worker, args=(s_,))
               for s_ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "worker hung"
    assert not errors, errors[:3]

    def total_conserved():
        rows = _scan_kv(client, table)
        return len(rows) == NACCT and sum(rows.values()) == NACCT * 1000
    wait_for(total_conserved, msg="balance conservation")


def test_intents_survive_restart(tmp_path):
    c = MiniCluster(str(tmp_path) + "/x", num_masters=1, num_tservers=3)
    c.start()
    try:
        c.wait_tservers_registered()
        client = c.client()
        table = client.create_table("dur", COLUMNS, num_tablets=2)
        mgr = TransactionManager(client)
        txn = mgr.begin()
        txn.insert(table, {"k": "p", "v": 1})
        txn.flush()
        committed = mgr.begin()
        committed.insert(table, {"k": "q", "v": 2})
        commit_ht = committed.commit()
        wait_for(lambda: _scan_kv(client, table, read_ht=commit_ht)
                 == {"q": 2}, msg="commit applied")
        # Flush every tablet so intents + txn state hit the sidecars.
        for ts in c.tservers.values():
            for peer in ts.tablet_manager.peers():
                peer.flush()
    finally:
        c.shutdown()
    c2 = MiniCluster(str(tmp_path) + "/x", num_masters=1, num_tservers=3)
    c2.start()
    try:
        c2.wait_tservers_registered()
        client2 = c2.client()
        table2 = client2.open_table("dur")

        def state_recovered():
            rows = _scan_kv(client2, table2)
            return rows.get("q") == 2 and "p" not in rows
        wait_for(state_recovered, msg="committed data after restart")
        # The orphaned pending txn's intents were recovered too, and the
        # coordinator (also recovered) eventually expires it.
        for ts in c2.tservers.values():
            for peer in ts.tablet_manager.peers():
                if peer.tablet.coordinator is not None:
                    peer.tablet.coordinator.expiry_s = 0.5
        s2 = YBSession(client2)

        def overwrite_succeeds():
            try:
                s2.insert(table2, {"k": "p", "v": 3})
                s2.flush()
                return True
            except Exception:
                return False
        wait_for(overwrite_succeeds, msg="recovered intent expiry")
    finally:
        c2.shutdown()
