"""Tablet splitting on the port's cluster, under the assertions of the JAX
package's ``tests/test_tablet_split.py``: the master-driven seal -> fork
-> seed -> commit protocol, per-tablet meta-cache invalidation, the
``tablet_split`` wire code, and the auto-split threshold pass. The
tablets run on the ``gpu`` engine over CPU tensors.
"""

import os
import tempfile
import time

import pytest

from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.client.session import YBSession
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema
from yugabyte_db_tpu_torch.storage.scan_spec import ScanSpec
from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.metrics import tablet_splits_total


@pytest.fixture(scope="module")
def cluster():
    with tempfile.TemporaryDirectory() as root:
        mc = MiniCluster(os.path.join(root, "c"), num_tservers=3).start()
        mc.wait_tservers_registered()
        try:
            yield mc
        finally:
            mc.shutdown()


@pytest.fixture(scope="module")
def table(cluster):
    client = cluster.client()
    t = client.create_table("split_t", [
        ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
        ColumnSchema("v", DataType.INT64)], num_tablets=2)
    s = YBSession(client)
    for i in range(200):
        s.insert(t, {"k": f"key-{i:04d}", "v": i})
    s.flush()
    return client, t


def test_meta_cache_invalidates_one_tablet_not_siblings(table):
    """Satellite regression: splitting one tablet must not evict the
    SIBLING tablets' cached locations or learned leader hints."""
    client, t = table
    locs = client.meta_cache.locations("split_t", refresh=True)
    assert len(locs.tablets) == 2
    victim, sibling = locs.tablets
    # Learn a leader hint on the sibling, then punch the victim out.
    client.meta_cache.mark_leader("split_t", sibling.tablet_id, "ts-1")
    client.meta_cache.invalidate_tablet("split_t", victim.tablet_id)
    cached = client.meta_cache._tables["split_t"].tablets
    assert [x.tablet_id for x in cached] == [sibling.tablet_id]
    assert cached[0] is sibling          # same object: nothing rebuilt
    assert cached[0].leader == "ts-1"    # hint survived the punch-out
    assert not client.meta_cache.covers("split_t", victim.partition_start)
    assert client.meta_cache.covers("split_t", sibling.partition_start)
    # A lookup into the punched range self-heals with ONE refresh.
    back = client.meta_cache.lookup_by_hash("split_t",
                                            victim.partition_start)
    assert back.tablet_id == victim.tablet_id
    # Unknown tablet ids are a no-op (idempotent double invalidation).
    client.meta_cache.invalidate_tablet("split_t", "no-such-tablet")
    assert len(client.meta_cache._tables["split_t"].tablets) == 2


def test_manual_split_preserves_data_and_lineage(cluster, table):
    client, t = table
    base_splits = tablet_splits_total()
    locs = client.meta_cache.locations("split_t", refresh=True)
    parent = locs.tablets[0].tablet_id
    resp = client.master_rpc(
        "master.split_tablet",
        {"table": "split_t", "tablet_id": parent, "timeout": 30.0},
        timeout_s=40.0)
    assert resp["code"] == "ok", resp
    children = resp["children"]
    assert len(children) == 2
    assert tablet_splits_total() == base_splits + 1

    # The parent's range was divided at an interior hash: children abut.
    locs = client.meta_cache.locations("split_t", refresh=True)
    ids = [x.tablet_id for x in locs.tablets]
    assert parent not in ids and set(children) <= set(ids)
    assert len(locs.tablets) == 3
    for a, b in zip(locs.tablets, locs.tablets[1:]):
        assert a.partition_end == b.partition_start

    # Every pre-split row is still readable; writes route to children.
    s = YBSession(client)
    res = s.scan(t, ScanSpec(projection=["k", "v"]))
    assert dict(res.rows) == {f"key-{i:04d}": i for i in range(200)}
    s.insert(t, {"k": "post-split", "v": 777})
    s.flush()
    assert s.get(t, {"k": "post-split"})[1] == 777

    # Replicated lineage: parent -> children, COMMITTED.
    m = cluster.masters["m-0"]
    lineage = {r["parent"]: r for r in m.catalog.split_lineage()}
    assert lineage[parent]["state"] == "COMMITTED"
    assert sorted(lineage[parent]["children"]) == sorted(children)


def test_stale_cache_replans_through_departed_parent(cluster, table):
    """A client that cached locations BEFORE the split (its cache still
    names the deleted parent) must transparently re-plan, not fail."""
    client, _t = table
    fresh = cluster.client()
    t2 = fresh.open_table("split_t")
    fresh.meta_cache.locations("split_t")  # prime the cache
    locs = client.meta_cache.locations("split_t", refresh=True)
    parent = locs.tablets[-1].tablet_id  # the un-split seed tablet
    resp = client.master_rpc(
        "master.split_tablet", {"tablet_id": parent, "timeout": 30.0},
        timeout_s=40.0)
    assert resp["code"] == "ok", resp
    # The stale client reads and writes through its dead cache entry.
    s = YBSession(fresh)
    res = s.scan(t2, ScanSpec(projection=["k", "v"]))
    assert len(res.rows) == 201  # 200 seed rows + post-split
    s.insert(t2, {"k": "stale-route", "v": 888})
    s.flush()
    assert s.get(t2, {"k": "stale-route"})[1] == 888


def test_sealed_tablet_answers_tablet_split_wire_code(cluster):
    """The seal gate's wire contract: a sealed parent rejects reads AND
    writes with ``code=tablet_split`` naming the tablet (what drives
    per-tablet invalidation client-side)."""
    from yugabyte_db_tpu_torch.storage import wire

    client = cluster.client()
    t = client.create_table("seal_t", [
        ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
        ColumnSchema("v", DataType.INT64)], num_tablets=1)
    s = YBSession(client)
    s.insert(t, {"k": "a", "v": 1})
    s.flush()
    # The flush just learned the leader (not_leader hint-following);
    # a master refresh could race the heartbeat and report None.
    loc = client.meta_cache.locations("seal_t").tablets[0]
    assert loc.leader is not None
    sealed = client.transport.send(
        loc.leader, "ts.split_seal",
        {"tablet_id": loc.tablet_id, "timeout": 5.0}, timeout=10.0)
    assert sealed["code"] == "ok", sealed
    w = client.transport.send(loc.leader, "ts.write", {
        "tablet_id": loc.tablet_id,
        "rows": wire.encode_rows([]), "timeout": 2.0}, timeout=5.0)
    assert w["code"] == "tablet_split"
    assert w["tablet_id"] == loc.tablet_id
    r = client.transport.send(loc.leader, "ts.scan", {
        "tablet_id": loc.tablet_id,
        "spec": wire.encode_spec(ScanSpec()), "timeout": 2.0},
        timeout=5.0)
    assert r["code"] == "tablet_split"
    client.delete_table("seal_t")


def test_auto_split_pass_triggers_on_size_threshold(cluster, table):
    """With ``--tablet_split_size_bytes`` live, the master's background
    pass splits an over-threshold tablet on its own (one per pass)."""
    client, _t = table
    m = cluster.masters["m-0"]
    before = len(m.catalog.split_lineage())
    FLAGS.set("tablet_split_size_bytes", 1, force=True)
    try:
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            done = [r for r in m.catalog.split_lineage()
                    if r["state"] == "COMMITTED"]
            if len(done) > before:
                break
            time.sleep(0.1)
        else:
            pytest.fail("auto-split pass never committed a split")
    finally:
        FLAGS.set("tablet_split_size_bytes", 0, force=True)
    # Data still intact after the background split.
    res = YBSession(client).scan(
        client.open_table("split_t"), ScanSpec(projection=["k"]))
    assert len(res.rows) == 202
