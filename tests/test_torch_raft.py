"""The port's Raft group (``consensus``, ``TabletPeer``) against the JAX one.

Three parts:

- Mirrors of the 10 tests of ``tests/test_raft.py`` (:99-271) on a port
  ``Group``: three ``TabletPeer``s of the port over its ``LocalTransport``,
  each tablet on the ``gpu`` engine over CPU tensors (the plain versions
  of its kernels). The wall-clock test moves ``time.time_ns``, the source
  both packages' ``HybridClock`` reads. Before it writes, a test waits
  for a leader that has also applied its own term's no_op
  (``leader_ready``), not only for the lease as the JAX tests do: under
  a loaded host the write could otherwise meet ``NotLeader``.
- A differential test: a JAX group (on each engine of ``JAX_ENGINES``, the
  ``tpu`` one as the JAX tests run it, on the CPU backend) and a port
  group take the same writes, updates, deletes and flushes. Every replica
  of both answers the same rows, and the leaders' aggregates are equal:
  integers exactly, DOUBLE sums within ``tests/test_engine_diff.py``'s
  rel/abs 1e-4 (no FLOAT column is summed).
- Files: a JAX group's directories, written, flushed and shut down, start
  port peers (only ``tablet-meta.json``'s engine changes); they elect a
  leader above the JAX term and read what the JAX group read. And the
  ``consensus-meta.json`` and WAL segments both packages write for the
  same inputs (clocks whose physical time stands still, no timers) are
  equal byte for byte.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from types import SimpleNamespace

import pytest

import yugabyte_db_tpu.consensus as JC
import yugabyte_db_tpu.models.datatypes as j_datatypes
import yugabyte_db_tpu.models.partition as j_partition
import yugabyte_db_tpu.models.schema as j_schema
import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu.tablet as JT
import yugabyte_db_tpu.utils.hybrid_time as j_ht
import yugabyte_db_tpu_torch.consensus as TC
import yugabyte_db_tpu_torch.models.datatypes as t_datatypes
import yugabyte_db_tpu_torch.models.partition as t_partition
import yugabyte_db_tpu_torch.models.schema as t_schema
import yugabyte_db_tpu_torch.storage as T
import yugabyte_db_tpu_torch.tablet as TT
import yugabyte_db_tpu_torch.utils.hybrid_time as t_ht

JAX_ENGINES = ["cpu", "tpu"]
NOW_US = 1_000_000  # a standing clock's physical time

JAXSIDE = SimpleNamespace(name="jax", C=JC, T=JT, S=J, schema=j_schema,
                          dt=j_datatypes, partition=j_partition, ht=j_ht)
PORTSIDE = SimpleNamespace(name="port", C=TC, T=TT, S=T, schema=t_schema,
                           dt=t_datatypes, partition=t_partition, ht=t_ht)


def fast(side):
    return side.C.RaftOptions(election_timeout_s=0.15,
                              heartbeat_interval_s=0.03, lease_s=0.4,
                              rpc_timeout_s=0.5)


def kv_schema(side):
    """``tests/test_raft.py``'s table."""
    S, D = side.schema, side.dt.DataType
    return S.Schema([S.ColumnSchema("k", D.STRING, S.ColumnKind.HASH),
                     S.ColumnSchema("v", D.INT64)], table_id="t")


def bench_schema(side):
    """The bench table's columns (``workload.make_schema``)."""
    S, D = side.schema, side.dt.DataType
    return S.Schema([S.ColumnSchema("k", D.STRING, S.ColumnKind.HASH),
                     S.ColumnSchema("r", D.INT64, S.ColumnKind.RANGE),
                     S.ColumnSchema("a", D.INT64),
                     S.ColumnSchema("c", D.DOUBLE),
                     S.ColumnSchema("d", D.INT32)], table_id="bench")


def wait_for(pred, timeout=5.0, interval=0.01, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


class Group:
    """A 3-replica (by default) raft group of one package's TabletPeers
    over its LocalTransport. The port's tablets run on the ``gpu`` engine
    over CPU tensors; the JAX package's on ``engine``."""

    def __init__(self, tmp_path, n=3, side=PORTSIDE, engine="cpu",
                 schema=None, clock=None):
        self.side = side
        self.engine = engine
        self.schema = schema if schema is not None else kv_schema(side)
        self.transport = side.C.LocalTransport()
        self.tmp_path = tmp_path
        self.clock = clock
        self.nodes = [f"node-{i}" for i in range(n)]
        self.peers = {}
        for uuid in self.nodes:
            self.start_node(uuid)

    def meta(self):
        if self.side is PORTSIDE:
            return TT.TabletMetadata("tablet-1", "t", self.schema, 0, 65536)
        return JT.TabletMetadata("tablet-1", "t", self.schema, 0, 65536,
                                 engine=self.engine)

    def engine_options(self):
        return {"device": "cpu"} if self.side is PORTSIDE else None

    def make_peer(self, uuid, peers):
        return self.side.T.TabletPeer(
            uuid, self.meta(), str(self.tmp_path / uuid),
            self.transport.bind(uuid), peers, fsync=False,
            raft_opts=fast(self.side),
            engine_options=self.engine_options(),
            clock=self.clock() if self.clock else None)

    def start_node(self, uuid):
        peer = self.make_peer(uuid, self.nodes)
        self.transport.register(
            uuid, lambda m, p, _pr=peer: _pr.raft.handle(m, p))
        self.peers[uuid] = peer
        peer.start()
        return peer

    def stop_node(self, uuid):
        self.transport.unregister(uuid)
        self.peers.pop(uuid).shutdown()

    def leader(self):
        """The peer that leads with a lease and has applied its own
        term's no_op (before that a write raises NotLeader)."""
        return wait_for(
            lambda: next((p for p in self.peers.values()
                          if p.raft.is_leader() and p.raft.has_lease()
                          and p.raft.leader_ready()),
                         None), msg="leader election")

    def shutdown(self):
        for p in list(self.peers.values()):
            p.shutdown()

    def key(self, k, r=None):
        d = {"k": k} if r is None else {"k": k, "r": r}
        return self.schema.encode_primary_key(
            d, self.side.partition.compute_hash_code(self.schema,
                                                     {"k": k}))

    def row(self, k, v):
        cid = {c.name: c.col_id for c in self.schema.columns}
        return self.side.S.RowVersion(self.key(k), ht=0, liveness=True,
                                      columns={cid["v"]: v})

    def read_all(self, peer):
        res = peer.scan(self.side.S.ScanSpec(
            read_ht=peer.tablet.clock.now().value), allow_stale=True)
        return sorted(res.rows)

    def write_retrying(self, rows, timeout=10.0):
        """Write through whichever peer leads, retrying ``NotLeader`` as a
        client does."""
        deadline = time.monotonic() + timeout
        while True:
            leader = self.leader()
            try:
                return leader.write(rows)
            except self.side.C.NotLeader:
                assert time.monotonic() < deadline, "no leader took it"
                time.sleep(0.02)


@pytest.fixture
def group(tmp_path):
    g = Group(tmp_path)
    yield g
    g.shutdown()


# -- tests/test_raft.py:99-271 on the port -----------------------------------

def test_elects_single_leader_and_replicates(group):
    leader = group.leader()
    for i in range(20):
        leader.write([group.row(f"k{i}", i)])
    want = group.read_all(leader)
    assert len(want) == 20
    for uuid, p in group.peers.items():
        wait_for(lambda p=p: p.raft.stats()["applied_index"]
                 >= leader.raft.stats()["applied_index"],
                 msg=f"{uuid} catchup")
        assert group.read_all(p) == want


def test_only_leader_accepts_writes(group):
    leader = group.leader()
    follower = next(p for p in group.peers.values() if p is not leader)
    with pytest.raises(TC.NotLeader) as ei:
        follower.write([group.row("x", 1)])
    assert ei.value.leader_hint == leader.node_uuid


def test_leader_failover_and_rejoin(group):
    leader = group.leader()
    leader.write([group.row("a", 1)])
    group.transport.isolate(leader.node_uuid)
    new_leader = wait_for(
        lambda: next((p for p in group.peers.values()
                      if p is not leader and p.raft.is_leader()
                      and p.raft.has_lease() and p.raft.leader_ready()),
                     None),
        msg="new leader after isolation")
    new_leader.write([group.row("b", 2)])
    # Old leader no longer holds a lease, so it refuses reads.
    wait_for(lambda: not leader.raft.has_lease(), msg="old lease expiry")
    with pytest.raises(TC.NotLeader):
        leader.scan(T.ScanSpec())
    # Heal: old leader steps down to follower and catches up.
    group.transport.heal(leader.node_uuid)
    wait_for(lambda: not leader.raft.is_leader(), msg="old leader steps down")
    wait_for(lambda: group.read_all(leader) == group.read_all(new_leader),
             msg="old leader catches up")
    assert len(group.read_all(leader)) == 2


def test_divergent_suffix_truncated(group):
    """A partitioned leader's uncommitted writes are erased on rejoin."""
    leader = group.leader()
    leader.write([group.row("committed", 1)])
    others = [p for p in group.peers.values() if p is not leader]
    group.transport.isolate(leader.node_uuid)
    with pytest.raises((TimeoutError, TC.NotLeader)):
        leader.write([group.row("orphan", 9)], timeout=0.4)
    new_leader = wait_for(
        lambda: next((p for p in others if p.raft.is_leader()
                      and p.raft.leader_ready()), None),
        msg="new leader")
    new_leader.write([group.row("winner", 2)])
    group.transport.heal(leader.node_uuid)
    wait_for(lambda: sorted(group.read_all(leader))
             == sorted(group.read_all(new_leader)),
             msg="rejoined log convergence")
    keys = group.read_all(leader)
    assert len(keys) == 2  # committed + winner, no orphan


def test_restart_recovers_data(group):
    leader = group.leader()
    for i in range(10):
        leader.write([group.row(f"k{i}", i)])
    want = group.read_all(leader)
    for uuid in list(group.peers):
        group.stop_node(uuid)
    for uuid in group.nodes:
        group.start_node(uuid)
    leader2 = group.leader()
    assert group.read_all(leader2) == want


def test_change_config_add_then_remove(group, tmp_path):
    leader = group.leader()
    for i in range(5):
        leader.write([group.row(f"k{i}", i)])
    # Add a fourth, empty peer; it must catch up from index 1.
    new_uuid = "node-3"
    new_peer = group.make_peer(new_uuid, group.nodes + [new_uuid])
    group.transport.register(new_uuid,
                             lambda m, p: new_peer.raft.handle(m, p))
    group.peers[new_uuid] = new_peer
    new_peer.start()
    leader.raft.change_config(group.nodes + [new_uuid])
    wait_for(lambda: group.read_all(new_peer) == group.read_all(leader),
             msg="new peer catchup")
    assert leader.raft.stats()["config"]["peers"] == group.nodes + [new_uuid]
    # Remove it again; it stops being part of majorities.
    leader.raft.change_config(group.nodes)
    wait_for(lambda: leader.raft.stats()["config"]["peers"] == group.nodes,
             msg="config shrink commit")
    leader.write([group.row("after-shrink", 7)])


def test_rf1_instant_leadership(tmp_path):
    g = Group(tmp_path, n=1)
    try:
        leader = g.leader()
        # Writes are accepted once the own-term no-op applies
        # (leader_ready); briefly rejected writes surface as NotLeader.
        deadline = time.monotonic() + 5.0
        while True:
            try:
                leader.write([g.row("solo", 1)])
                break
            except TC.NotLeader:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        assert len(g.read_all(leader)) == 1
    finally:
        g.shutdown()


def test_no_progress_without_majority(group):
    leader = group.leader()
    for p in group.peers.values():
        if p is not leader:
            group.transport.isolate(p.node_uuid)
    with pytest.raises((TimeoutError, TC.NotLeader)):
        leader.write([group.row("stuck", 1)], timeout=0.4)
    group.transport.heal()

    def can_write():
        for p in group.peers.values():
            try:
                p.write([group.row("ok", 2)], timeout=1.0)
                return True
            except (TC.NotLeader, TimeoutError):
                continue
        return False
    wait_for(can_write, timeout=10.0, msg="post-heal write")


def test_message_borne_lease_expires_when_isolated(group):
    """An isolated leader drops its lease within one lease window, and
    the replacement holds one only after the old promises expired."""
    leader = group.leader()
    assert leader.raft.has_lease()
    group.transport.isolate(leader.node_uuid)
    wait_for(lambda: not leader.raft.has_lease(), timeout=3.0,
             msg="lease expiry after isolation")
    new = wait_for(
        lambda: next((p for p in group.peers.values()
                      if p.node_uuid != leader.node_uuid
                      and p.raft.is_leader() and p.raft.has_lease()),
                     None), timeout=5.0, msg="replacement leader")
    assert not leader.raft.has_lease()
    group.transport.heal()
    wait_for(lambda: not leader.raft.is_leader(), timeout=5.0,
             msg="old leader steps down")
    assert new.raft.has_lease()


def test_wall_clock_jump_does_not_affect_leases_or_order(group,
                                                         monkeypatch):
    """Jump the WALL clock an hour ahead: leases (monotonic durations)
    are unaffected and hybrid times keep growing everywhere; back again,
    hybrid time never regresses."""
    leader = group.leader()
    ht1 = leader.write([group.row("before-jump", 1)])
    real_ns = t_ht.time.time_ns
    monkeypatch.setattr(t_ht.time, "time_ns",
                        lambda: real_ns() + 3600 * 10**9)
    assert leader.raft.has_lease()  # monotonic lease unaffected
    ht2 = leader.write([group.row("after-jump", 2)])
    assert ht2.value > ht1.value
    wait_for(lambda: all(
        p.tablet.clock.now().value > ht2.value
        for p in group.peers.values()), timeout=3.0,
        msg="clock propagation")
    monkeypatch.setattr(t_ht.time, "time_ns", real_ns)
    ht3 = leader.write([group.row("after-restore", 3)])
    assert ht3.value > ht2.value
    assert leader.raft.has_lease()


# -- the same writes through a JAX group and a port group --------------------

def bench_batches(side, schema, seed=7):
    """Batches of bench-table rows: inserts, one-field updates, deletes
    (the same values on both sides for one seed)."""
    import random

    rng = random.Random(seed)
    RV = side.S.RowVersion
    cid = {c.name: c.col_id for c in schema.columns}
    kf = lambda i: schema.encode_primary_key(  # noqa: E731
        {"k": f"user{i:04d}", "r": i % 3},
        side.partition.compute_hash_code(schema, {"k": f"user{i:04d}"}))
    out = []
    for b in range(6):
        out.append([RV(kf(b * 40 + j), ht=0, liveness=True, columns={
            cid["a"]: rng.randrange(-10**12, 10**12),
            cid["c"]: rng.uniform(-1e3, 1e3),
            cid["d"]: rng.randrange(-10**6, 10**6)}) for j in range(40)])
    for _ in range(4):
        batch = []
        for _ in range(30):
            i = rng.randrange(240)
            roll = rng.random()
            if roll < 0.15:
                batch.append(RV(kf(i), ht=0, tombstone=True))
            elif roll < 0.3:
                batch.append(RV(kf(i), ht=0, columns={cid["c"]: None}))
            else:
                batch.append(RV(kf(i), ht=0, columns={
                    cid["d"]: rng.randrange(-10**6, 10**6)}))
        out.append(batch)
    return out


def headline(side, read_ht, lo):
    S = side.S
    return S.ScanSpec(read_ht=read_ht,
                      predicates=[S.Predicate("d", ">=", lo)],
                      aggregates=[S.AggSpec("count", None),
                                  S.AggSpec("sum", "a"),
                                  S.AggSpec("min", "a"),
                                  S.AggSpec("max", "d"),
                                  S.AggSpec("sum", "c"),
                                  S.AggSpec("count", "c")])


def same_values(got, want, label):
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-4, abs=1e-4), label
        else:
            assert g == w, (label, got, want)


def check_groups(jg, tg, label):
    """Every replica of both groups answers the same rows; the leaders'
    headline aggregates agree."""
    jl, tl = jg.leader(), tg.leader()
    for g, l in ((jg, jl), (tg, tl)):
        target = l.raft.stats()["commit_index"]
        for p in g.peers.values():
            wait_for(lambda p=p: p.raft.stats()["applied_index"] >= target,
                     msg=f"{label}: {p.node_uuid} apply")
    want = jg.read_all(jl)
    assert want, label
    for g in (jg, tg):
        for p in g.peers.values():
            assert g.read_all(p) == want, (label, g.side.name, p.node_uuid)
    for lo in (-10**6, 0, 500_000):
        gt = tl.scan(headline(PORTSIDE, tl.read_time().value, lo)).rows[0]
        wj = jl.scan(headline(JAXSIDE, jl.read_time().value, lo)).rows[0]
        same_values(gt, wj, (label, lo))


@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_port_group_answers_as_the_jax_group(tmp_path, jax_engine):
    jg = Group(tmp_path / "jax", side=JAXSIDE, engine=jax_engine,
               schema=bench_schema(JAXSIDE))
    tg = Group(tmp_path / "port", schema=bench_schema(PORTSIDE))
    try:
        jb = bench_batches(JAXSIDE, jg.schema)
        tb = bench_batches(PORTSIDE, tg.schema)
        for i in range(6):
            jg.write_retrying(jb[i])
            tg.write_retrying(tb[i])
        check_groups(jg, tg, "inserts")
        # Every replica flushes; the updates then sit over the runs.
        for g in (jg, tg):
            for p in g.peers.values():
                p.flush()
        for i in range(6, 10):
            jg.write_retrying(jb[i])
            tg.write_retrying(tb[i])
        check_groups(jg, tg, "updates over runs")
        for g in (jg, tg):
            g.leader().flush()
        check_groups(jg, tg, "leader flushed")
    finally:
        jg.shutdown()
        tg.shutdown()


# -- files -------------------------------------------------------------------

def test_port_peers_start_on_a_jax_groups_directories(tmp_path):
    jg = Group(tmp_path / "jax", side=JAXSIDE, schema=bench_schema(JAXSIDE))
    try:
        batches = bench_batches(JAXSIDE, jg.schema, seed=11)
        for b in batches[:6]:
            jg.write_retrying(b)
        for p in jg.peers.values():
            p.flush()
        for b in batches[6:8]:
            jg.write_retrying(b)
        jl = jg.leader()
        target = jl.raft.stats()["commit_index"]
        for p in jg.peers.values():
            wait_for(lambda p=p: p.raft.stats()["applied_index"] >= target,
                     msg="jax apply")
        want_rows = jg.read_all(jl)
        want_aggs = [jl.scan(headline(JAXSIDE, jl.read_time().value,
                                      lo)).rows[0] for lo in (-10**6, 0)]
        jax_term = max(p.raft.stats()["term"] for p in jg.peers.values())
    finally:
        jg.shutdown()
    # The copy: only each tablet-meta.json's engine field changes.
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    for uuid in jg.nodes:
        path = tmp_path / "port" / uuid / "tablet-1" / "tablet-meta.json"
        meta = json.loads(path.read_text())
        meta["engine"] = "gpu"
        path.write_text(json.dumps(meta))
    tg = Group.__new__(Group)
    tg.side, tg.engine, tg.clock = PORTSIDE, "gpu", None
    tg.schema = bench_schema(PORTSIDE)
    tg.transport = TC.LocalTransport()
    tg.tmp_path = tmp_path / "port"
    tg.nodes = list(jg.nodes)
    tg.peers = {}
    try:
        for uuid in tg.nodes:
            tg.start_node(uuid)
        tl = tg.leader()
        assert tl.raft.stats()["term"] > jax_term
        wait_for(lambda: tl.raft.leader_ready(), msg="own-term no_op")
        for p in tg.peers.values():
            assert tg.read_all(p) == want_rows, p.node_uuid
        for lo, want in zip((-10**6, 0), want_aggs):
            got = tl.scan(headline(PORTSIDE, tl.read_time().value,
                                   lo)).rows[0]
            same_values(got, want, lo)
        # Both groups go on: the port's over the JAX group's runs and log,
        # the JAX group restarted on its own directories.
        for uuid in jg.nodes:
            jg.start_node(uuid)
        jg.write_retrying(batches[8])
        tg.write_retrying(bench_batches(PORTSIDE, tg.schema, seed=11)[8])
        check_groups(jg, tg, "after the restart")
    finally:
        tg.shutdown()
        jg.shutdown()


def standing_clock(side):
    return lambda: side.ht.HybridClock(now_micros=lambda: NOW_US)


def drive_follower(side, root):
    """A follower's RaftConsensus (no timers) fed the same vote and
    AppendEntries requests: terms, writes, a config change, a divergent
    suffix replaced, the commit index advancing. Returns its state."""
    os.makedirs(root, exist_ok=True)
    cmeta = side.C.ConsensusMetadata(os.path.join(root, "consensus-meta.json"),
                                     "node-1",
                                     side.C.RaftConfig(["node-0", "node-1",
                                                        "node-2"]))
    log = side.T.Log(os.path.join(root, "wal"), fsync=False)
    applied = []
    raft = side.C.RaftConsensus("tablet-1", cmeta, log,
                                side.C.LocalTransport(),
                                side.ht.HybridClock(now_micros=lambda:
                                                    NOW_US),
                                applied.append)
    schema = kv_schema(side)
    cid = schema.column("v").col_id
    from_wire = (__import__("yugabyte_db_tpu.storage.wire",
                            fromlist=["encode_rows"]) if side is JAXSIDE
                 else __import__("yugabyte_db_tpu_torch.storage.wire",
                                 fromlist=["encode_rows"]))
    ht0 = NOW_US << 12

    def rows(i):
        key = schema.encode_primary_key(
            {"k": f"k{i}"}, side.partition.compute_hash_code(
                schema, {"k": f"k{i}"}))
        return from_wire.encode_rows([side.S.RowVersion(
            key, ht=ht0 + i, liveness=True, columns={cid: i * 7})])

    out = []
    out.append(raft.handle_request_vote({
        "term": 1, "candidate": "node-0", "last_log_term": 0,
        "last_log_index": 0}))
    rec = lambda t, i, op, body, c: [t, i, ht0 + i, op, body, c]  # noqa
    out.append(raft.handle_update_consensus({
        "term": 1, "leader": "node-0", "prev_index": 0, "prev_term": 0,
        "entries": [rec(1, 1, "no_op", None, 0),
                    rec(1, 2, "write", rows(2), 1),
                    rec(1, 3, "write", {"rows": rows(3),
                                        "rid": ["client-a", 4]}, 2)],
        "commit_index": 2, "lease_s": 0.0}))
    # A new leader in term 2 replaces the uncommitted index 3.
    out.append(raft.handle_request_vote({
        "term": 2, "candidate": "node-2", "last_log_term": 1,
        "last_log_index": 3, "ignore_live_leader": True}))
    out.append(raft.handle_update_consensus({
        "term": 2, "leader": "node-2", "prev_index": 2, "prev_term": 1,
        "entries": [rec(2, 3, "no_op", None, 2),
                    rec(2, 4, "change_config",
                        {"peers": ["node-0", "node-1", "node-2", "node-3"],
                         "opid_index": 0}, 2),
                    rec(2, 5, "write", rows(5), 3)],
        "commit_index": 5, "lease_s": 0.0}))
    raft._drain_applies()
    out.append([e.op_id.index for e in applied])
    out.append(raft.stats())
    out.append(raft.log_tail_snapshot())
    log.sync()
    log.close()
    return out


def tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for n in files:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_consensus_files_equal_the_jax_files(tmp_path):
    """The follower's ``consensus-meta.json`` and WAL segments, and an RF 1
    peer's whole directory minus the engine's run files (the same writes,
    a standing clock each), are the JAX package's bytes."""
    got = drive_follower(PORTSIDE, str(tmp_path / "port" / "f"))
    want = drive_follower(JAXSIDE, str(tmp_path / "jax" / "f"))
    assert got == want
    assert got[5]["applied_index"] == 5
    assert got[5]["config"]["peers"] == ["node-0", "node-1", "node-2",
                                         "node-3"]
    files_t = tree_bytes(str(tmp_path / "port" / "f"))
    files_j = tree_bytes(str(tmp_path / "jax" / "f"))
    assert set(files_t) == set(files_j) and "consensus-meta.json" in files_t
    assert any(n.startswith("wal/") for n in files_t)
    for n in files_j:
        assert files_t[n] == files_j[n], n
    # An RF 1 peer of each package: election, own no_op, writes, flush.
    trees = {}
    for side in (PORTSIDE, JAXSIDE):
        g = Group(tmp_path / f"rf1-{side.name}", n=1, side=side,
                  clock=standing_clock(side))
        try:
            leader = g.leader()
            wait_for(lambda: leader.raft.leader_ready(), msg="no_op applied")
            for i in range(5):
                leader.write([g.row(f"k{i}", i)])
            leader.flush()
            leader.write([g.row("after", 9)])
            trees[side.name] = (g.read_all(leader),
                                leader.raft.stats()["term"])
        finally:
            g.shutdown()
        trees[side.name] += (tree_bytes(str(tmp_path / f"rf1-{side.name}")),)
    rows_t, term_t, files_t = trees["port"]
    rows_j, term_j, files_j = trees["jax"]
    assert rows_t == rows_j and term_t == term_j == 1
    assert set(files_t) == set(files_j)
    for n, data in files_j.items():
        if n.endswith("tablet-meta.json"):
            meta_t, meta_j = json.loads(files_t[n]), json.loads(data)
            assert meta_t.pop("engine") == "gpu"
            assert meta_j.pop("engine") == "cpu"
            assert meta_t == meta_j
            continue
        assert files_t[n] == data, n
