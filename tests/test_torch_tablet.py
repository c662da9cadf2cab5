"""The port's ``Tablet`` on the ``gpu`` engine against the JAX ``Tablet``.

Both tablets get the same inputs and a ``HybridClock`` whose physical
time stands still (``now_micros`` constant), so each write is stamped
with the next logical hybrid time on both sides and every scan at a read
point compares. The JAX tablet runs on its ``cpu`` and ``tpu`` engines
(the ``tpu`` engine as the JAX tests run it, on the CPU backend), the
port's on ``gpu`` over CPU tensors (the plain versions of its kernels).
Tolerance: integers, strings, counts, keys, WAL and wire bytes exact;
DOUBLE values within ``tests/test_engine_diff.py``'s rel/abs 1e-4 (no
test sums a FLOAT column).

- Mirrors of ``tests/test_tablet.py:123-235`` (write, read, restart; the
  flush frontier and WAL GC; an MVCC snapshot after a restart; intra-batch
  write ids) and ``tests/test_snapshot.py:111``.
- One sequence of log entries through ``apply_replicated`` on both
  tablets, with a restart in the middle: every op type of
  ``_apply_entry_body`` (writes with a row-list body, a dict body with a
  request id and a row-block body; intents, their apply and removal;
  ALTER; snapshot create, restore and delete; the split seal), each step
  compared through aggregates, GROUP BY, LIMIT pages and their resume
  keys, exact-key reads, wire pages, ``stats()``'s common keys and
  ``dump_entries()``.
- A tablet directory written by the JAX tablet on ``cpu``, opened by the
  port (only the copy's ``tablet-meta.json`` engine field is rewritten).
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu.tablet as JT
import yugabyte_db_tpu_torch.storage as T
import yugabyte_db_tpu_torch.tablet as TT
from test_torch_data import JAX, MAX_HT, PORT, make_schema
from yugabyte_db_tpu.models.datatypes import DataType as JType
from yugabyte_db_tpu.storage import rowblock as j_rowblock
from yugabyte_db_tpu.storage import wire as j_wire
from yugabyte_db_tpu.utils.hybrid_time import HybridClock as JClock
from yugabyte_db_tpu_torch.models.datatypes import DataType as TType
from yugabyte_db_tpu_torch.storage import rowblock as t_rowblock
from yugabyte_db_tpu_torch.storage import wire as t_wire
from yugabyte_db_tpu_torch.storage.breaker import CLOSED
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock as TClock
from yugabyte_db_tpu_torch.utils.retry import Deadline, DeadlineExpired
from yugabyte_db_tpu_torch.utils.status import AlreadyPresent

JAX_ENGINES = ["cpu", "tpu"]
NOW_US = 1_000_000  # the clocks' physical time, standing still


def kv_schema(S):
    """``tests/test_tablet.py``'s table."""
    return S.Schema([
        S.ColumnSchema("k", S.DataType.STRING, S.ColumnKind.HASH),
        S.ColumnSchema("r", S.DataType.INT64, S.ColumnKind.RANGE),
        S.ColumnSchema("v", S.DataType.STRING)], table_id="t")


def kv_key(side, schema, k, r):
    return schema.encode_primary_key(
        {"k": k, "r": r}, side.partition.compute_hash_code(schema, {"k": k}))


def jax_rows(rows):
    """The JAX package's RowVersions of the port's ``rows``, every field
    (relative TTLs and counter increments too)."""
    RV = JAX.row_version.RowVersion
    return [RV(r.key, ht=r.ht, tombstone=r.tombstone, liveness=r.liveness,
               columns=dict(r.columns), expire_ht=r.expire_ht,
               ttl_us=r.ttl_us, write_id=r.write_id,
               increments=dict(r.increments))
            for r in rows]


class Pair:
    """A JAX tablet and a port tablet of one table, driven together."""

    def __init__(self, root, tablet_id, jschema, pschema, jax_engine,
                 rows_per_block=16, consensus_managed=False, table="t"):
        self.root = root
        self.tid = tablet_id
        self.jax_engine = jax_engine
        self.kw = dict(rows_per_block=rows_per_block,
                       consensus_managed=consensus_managed)
        jmeta = JT.TabletMetadata(tablet_id, table, jschema, 0, 65536,
                                  engine=jax_engine)
        # The port's metadata names its ``gpu`` engine by default.
        pmeta = TT.TabletMetadata(tablet_id, table, pschema, 0, 65536)
        assert pmeta.engine == "gpu"
        self.j = JT.Tablet.create(jmeta, str(root / "jax"),
                                  **self._jkw())
        self.t = TT.Tablet.create(pmeta, str(root / "port"),
                                  **self._tkw())

    def _jkw(self):
        return dict(clock=JClock(now_micros=lambda: NOW_US), fsync=False,
                    consensus_managed=self.kw["consensus_managed"],
                    engine_options={"rows_per_block":
                                    self.kw["rows_per_block"]})

    def _tkw(self):
        return dict(clock=TClock(now_micros=lambda: NOW_US), fsync=False,
                    consensus_managed=self.kw["consensus_managed"],
                    engine_options={"rows_per_block":
                                    self.kw["rows_per_block"],
                                    "device": "cpu"})

    def write(self, rows, **kw):
        """``Tablet.write`` of the port's ``rows`` on both sides: the same
        hybrid time."""
        hj = self.j.write(jax_rows(rows), **kw)
        ht = self.t.write(rows, **kw)
        assert ht.value == hj.value
        return ht

    def both(self, fn):
        fn(self.j)
        fn(self.t)

    def close(self):
        self.j.close()
        self.t.close()

    def reopen(self):
        self.close()
        self.j = JT.Tablet.open(self.tid, str(self.root / "jax"),
                                **self._jkw())
        self.t = TT.Tablet.open(self.tid, str(self.root / "port"),
                                **self._tkw())
        assert self.t._replayed_on_bootstrap == \
            self.j._replayed_on_bootstrap
        return self.t._replayed_on_bootstrap


def spec_of(S, kw):
    k = dict(kw)
    if kw.get("aggregates"):
        k["aggregates"] = [S.AggSpec(*a) for a in kw["aggregates"]]
    k["predicates"] = [S.Predicate(*p) for p in kw.get("predicates", [])]
    return S.ScanSpec(**k)


def same_result(got, want, label):
    assert got.columns == want.columns, label
    assert len(got.rows) == len(want.rows), (label, got.rows, want.rows)
    for gr, wr in zip(got.rows, want.rows):
        for g, w in zip(gr, wr):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-4, abs=1e-4), label
            else:
                assert g == w, (label, gr, wr)
    assert got.resume_key == want.resume_key, label


def compare_scans(pair, specs, label=""):
    got = pair.t.scan_many([spec_of(T, kw) for kw in specs])
    want = pair.j.scan_many([spec_of(J, kw) for kw in specs])
    for kw, g, w in zip(specs, got, want):
        same_result(g, w, (label, kw))
    st = pair.t.engine.stats()
    assert st["host_reserves"] == 0
    assert st["breaker"] == {"state": CLOSED, "trips": 0}
    return got


def entries_fields(entries) -> list:
    return [(k, [(v.key, v.ht, v.tombstone, v.liveness, v.columns,
                  v.expire_ht, v.write_id) for v in vs])
            for k, vs in entries]


# -- tests/test_tablet.py:123-235 -----------------------------------------

@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_tablet_write_read_restart(tmp_path, jax_engine):
    ps, js = kv_schema(PORT.schema), kv_schema(JAX.schema)
    ids = {c.name: c.col_id for c in ps.value_columns}
    RV = PORT.row_version.RowVersion
    pair = Pair(tmp_path, "t1", js, ps, jax_engine)
    for i in range(30):
        pair.write([RV(kv_key(PORT, ps, "a", i), ht=0, liveness=True,
                       columns={ids["v"]: f"val{i}"})])
    read = pair.t.read_time().value
    assert read == pair.j.read_time().value
    res = compare_scans(pair, [dict(read_ht=read)])[0]
    assert len(res.rows) == 30
    # Restart WITHOUT flush: everything comes back from the WAL.
    assert pair.reopen() == 30
    res2 = compare_scans(pair, [dict(read_ht=MAX_HT)])[0]
    assert res2.rows == res.rows
    pair.close()


@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_tablet_flush_frontier_and_wal_gc(tmp_path, jax_engine):
    ps, js = kv_schema(PORT.schema), kv_schema(JAX.schema)
    ids = {c.name: c.col_id for c in ps.value_columns}
    RV = PORT.row_version.RowVersion
    pair = Pair(tmp_path, "t2", js, ps, jax_engine)
    pair.j.log.segment_bytes = pair.t.log.segment_bytes = 512  # force rolls
    for i in range(60):
        pair.write([RV(kv_key(PORT, ps, "a", i), ht=0, liveness=True,
                       columns={ids["v"]: f"v{i}"})])
    pair.both(lambda t: t.flush())
    assert pair.t.meta.flushed_op_index == 60
    assert sorted(os.listdir(pair.t.log.wal_dir)) == \
        sorted(os.listdir(pair.j.log.wal_dir))
    for i in range(60, 80):
        pair.write([RV(kv_key(PORT, ps, "a", i), ht=0, liveness=True,
                       columns={ids["v"]: f"v{i}"})])
    # Only the 20 writes after the flush replay; the rest loads from runs.
    assert pair.reopen() == 20
    res = compare_scans(pair, [dict(read_ht=MAX_HT, projection=["r"])])[0]
    assert [r[0] for r in res.rows] == list(range(80))
    pair.close()


@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_tablet_mvcc_snapshot_after_restart(tmp_path, jax_engine):
    ps, js = kv_schema(PORT.schema), kv_schema(JAX.schema)
    ids = {c.name: c.col_id for c in ps.value_columns}
    RV = PORT.row_version.RowVersion
    pair = Pair(tmp_path, "t3", js, ps, jax_engine)
    key = kv_key(PORT, ps, "a", 1)
    ht1 = pair.write([RV(key, ht=0, liveness=True, columns={ids["v"]: "x"})])
    ht2 = pair.write([RV(key, ht=0, columns={ids["v"]: "y"})])
    pair.write([RV(key, ht=0, tombstone=True)])
    pair.reopen()
    got = compare_scans(pair, [dict(read_ht=ht1.value),
                               dict(read_ht=ht2.value),
                               dict(read_ht=MAX_HT)])
    assert [g.rows for g in got] == [[("a", 1, "x")], [("a", 1, "y")], []]
    # The clock ratcheted past the replayed hybrid times.
    ht4 = pair.write([RV(key, ht=0, liveness=True, columns={ids["v"]: "z"})])
    assert ht4 > ht2
    pair.close()


@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_intra_batch_write_id_ordering(tmp_path, jax_engine):
    ps, js = kv_schema(PORT.schema), kv_schema(JAX.schema)
    cid = {c.name: c.col_id for c in ps.columns}
    RV = PORT.row_version.RowVersion
    pair = Pair(tmp_path, "t4", js, ps, jax_engine)
    key = kv_key(PORT, ps, "dup", 0)
    pair.write([RV(key, ht=0, liveness=True, columns={cid["v"]: "a"}),
                RV(key, ht=0, liveness=True, columns={cid["v"]: "b"}),
                RV(key, ht=0, columns={cid["v"]: "c"})])
    for label in ("memtable", "flushed"):
        got = compare_scans(pair, [dict(read_ht=pair.t.read_time().value,
                                        projection=["k", "v"])], label)
        assert got[0].rows == [("dup", "c")], label
        pair.both(lambda t: t.flush())
    # A same-batch DELETE shadows same-ht writes wherever it stands.
    pair.write([RV(key, ht=0, liveness=True, columns={cid["v"]: "z"}),
                RV(key, ht=0, tombstone=True)])
    got = compare_scans(pair, [dict(read_ht=pair.t.read_time().value)])
    assert got[0].rows == []
    pair.close()


@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_snapshot_local_tablet(tmp_path, jax_engine):
    """``tests/test_snapshot.py:111``."""
    def schema(S):
        return S.Schema([
            S.ColumnSchema("k", S.DataType.STRING, S.ColumnKind.HASH),
            S.ColumnSchema("v", S.DataType.INT64)], table_id="t")

    ps, js = schema(PORT.schema), schema(JAX.schema)
    cid = ps.column("v").col_id
    RV = PORT.row_version.RowVersion
    pair = Pair(tmp_path, "t-0001", js, ps, jax_engine)

    def key(i):
        return ps.encode_primary_key(
            {"k": f"x{i}"},
            PORT.partition.compute_hash_code(ps, {"k": f"x{i}"}))

    pair.write([RV(key(i), ht=0, liveness=True, columns={cid: i})
                for i in range(8)])
    pair.both(lambda t: t.snapshot_op("create_snapshot", "base"))
    snap = pair.t.snapshots_dir() + "/base"
    assert sorted(os.listdir(snap)) == sorted(
        os.listdir(pair.j.snapshots_dir() + "/base"))
    for n in os.listdir(snap):
        if n.startswith("run-"):
            assert open(os.path.join(snap, n), "rb").read() == open(
                os.path.join(pair.j.snapshots_dir(), "base", n),
                "rb").read()
    pair.write([RV(key(i), ht=0, liveness=True, columns={cid: -i})
                for i in range(8)])
    spec = [dict(read_ht=pair.t.read_time().value, projection=["k", "v"])]
    assert all(v <= 0 for _k, v in compare_scans(pair, spec)[0].rows)
    pair.both(lambda t: t.snapshot_op("restore_snapshot", "base"))
    spec = [dict(read_ht=pair.t.read_time().value, projection=["k", "v"])]
    assert sorted(v for _k, v in compare_scans(pair, spec)[0].rows) == \
        list(range(8))
    assert pair.t.list_snapshots() == ["base"]
    assert pair.t.dump_snapshots().keys() == {"base"}
    pair.both(lambda t: t.snapshot_op("delete_snapshot", "base"))
    assert pair.t.list_snapshots() == []
    assert os.path.isdir(pair.t.dir)
    pair.close()


# -- one replicated log, every op type, a restart in the middle -------------

def mixed_rows(schema, n, ht0, seed):
    """Rows of the ``mixed`` table (port classes) at hybrid times from
    ``ht0``: live rows, updates, NULLs, deletes and TTL'd rows."""
    import random

    rng = random.Random(seed)
    RV = PORT.row_version.RowVersion
    cid = {c.name: c.col_id for c in schema.value_columns}
    out = []
    for i in range(n):
        key = kv_key(PORT, schema, f"u{rng.randrange(40):03d}",
                     rng.randrange(3))
        ht = ht0 + i
        roll = rng.random()
        if roll < 0.08:
            out.append(RV(key, ht=ht, tombstone=True))
            continue
        cols = {cid["a"]: rng.randrange(-10**9, 10**9),
                cid["b"]: rng.choice(["xy", "xyz", "zz", None]),
                cid["d"]: rng.randrange(-1000, 1000)}
        if rng.random() < 0.5:
            cols[cid["c"]] = rng.uniform(-100.0, 100.0)
        ttl = rng.choice([1, 10**6]) if roll > 0.95 else None
        out.append(RV(key, ht=ht, liveness=roll < 0.8, columns=cols,
                      ttl_us=ttl, expire_ht=MAX_HT))
    return out


def stamped(rows, ht):
    """What a leader stamps: every row at ``ht``, TTLs resolved,
    intra-batch write ids."""
    RV = PORT.row_version.RowVersion
    return [RV(r.key, ht=ht, tombstone=r.tombstone, liveness=r.liveness,
               columns=r.columns, expire_ht=r.resolve_ttl(ht), write_id=i)
            for i, r in enumerate(rows)]


class Replicator:
    """The consensus stand-in: appends each entry to both tablets' logs
    (committed at once) and applies it through ``apply_replicated``."""

    def __init__(self, pair):
        self.pair = pair
        self.index = 0
        self.ht = (NOW_US << 12) + 1_000

    def next_ht(self) -> int:
        self.ht += 10
        return self.ht

    def send(self, op_type, body_of):
        """``body_of(side)`` gives the entry's body for side "jax" or
        "port" (the same bytes once encoded)."""
        self.index += 1
        ht = self.next_ht()
        for side, tablet, W in (("jax", self.pair.j, JT),
                                ("port", self.pair.t, TT)):
            entry = W.LogEntry(W.OpId(1, self.index), ht, op_type,
                               body_of(side, ht), committed=self.index)
            tablet.log.append(entry)
            tablet.log.sync()
            tablet.apply_replicated(entry)
        return ht


def state_checks(pair, schema, label):
    """Aggregates, GROUP BY, pages with their resume keys, exact-key
    reads, wire pages, stats and dump_entries at the tablets' read
    point."""
    read = pair.t.read_time().value
    assert read == pair.j.read_time().value, label
    names = [c.name for c in pair.t.meta.schema.value_columns]
    aggs = [("count", None), ("sum", "a"), ("min", "d"), ("max", "a"),
            ("count", "b")]
    k5 = kv_key(PORT, schema, "u005", 1)
    specs = [
        dict(read_ht=read, aggregates=aggs),
        dict(read_ht=read, aggregates=aggs, predicates=[("d", ">=", 0)]),
        dict(read_ht=read, aggregates=[("count", None), ("sum", "a")],
             group_by=["b"]),
        dict(read_ht=read, limit=9),
        dict(read_ht=read, limit=9, predicates=[("a", ">", 0)]),
        dict(read_ht=read, lower=k5, upper=k5 + b"\x00"),
        dict(read_ht=read),
    ]
    got = compare_scans(pair, specs, label)
    # Resume the first page to its end.
    page, resumes = got[3], 0
    while page.resume_key is not None and resumes < 12:
        kw = dict(read_ht=read, limit=9, lower=page.resume_key)
        page = compare_scans(pair, [kw], (label, "resume"))[0]
        resumes += 1
    for fmt in ("cql", "pg"):
        wj = pair.j.scan_wire_many([spec_of(J, kw) for kw in specs[3:]],
                                   fmt)
        wt = pair.t.scan_wire_many([spec_of(T, kw) for kw in specs[3:]],
                                   fmt)
        assert [(p.nrows, p.resume, bytes(p.data)) for p in wt] == \
            [(p.nrows, p.resume, bytes(p.data)) for p in wj], (label, fmt)
    for k in (k5, kv_key(PORT, schema, "u017", 0)):
        assert pair.t.current_row_values(k) == \
            pair.j.current_row_values(k), label
        assert pair.t.latest_committed_ht(k) == \
            pair.j.latest_committed_ht(k), label
    assert set(names) <= set(got[-1].columns)
    sj, st = pair.j.stats(), pair.t.stats()
    for key in ("tablet_id", "last_index", "applied_index",
                "flushed_op_index", "wal_segments"):
        assert st[key] == sj[key], (label, key)
    if pair.jax_engine == "tpu":
        # The engines' own counters and their runs' entries compare with
        # the JAX device engine's (the JAX cpu engine flushes at other
        # points: it does not flush at ALTER).
        for key in ("num_runs", "memtable_versions", "run_versions",
                    "flushed_frontier_ht"):
            assert st[key] == sj[key], (label, key)
        assert entries_fields(pair.t.engine.dump_entries()) == \
            entries_fields(pair.j.engine.dump_entries()), label


@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_replicated_entries_every_op_type(tmp_path, jax_engine):
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    pair = Pair(tmp_path, "t5", js, ps, jax_engine, consensus_managed=True)
    rep = Replicator(pair)

    def wire_body(rows):
        def body(side, ht):
            s = stamped(rows, ht)
            return (t_wire.encode_rows(s) if side == "port"
                    else j_wire.encode_rows(jax_rows(s)))
        return body

    # A row-list body, a dict body with a request id, a row-block body.
    rep.send("write", wire_body(mixed_rows(ps, 60, 0, 1)))
    rows2 = mixed_rows(ps, 40, 0, 2)

    def rid_body(side, ht):
        return {"rows": wire_body(rows2)(side, ht), "rid": ["client-a", 7]}

    ht_rid = rep.send("write", rid_body)
    rows3 = mixed_rows(ps, 30, 0, 3)

    def block_body(side, ht):
        s = stamped(rows3, ht)
        block = (t_rowblock.encode_rows(s) if side == "port"
                 else j_rowblock.encode_rows(jax_rows(s)))
        return block

    rep.send("write", block_body)
    assert pair.t.retryable.seen("client-a", 7) == ht_rid
    state_checks(pair, ps, "writes")
    pair.both(lambda t: t.flush())
    # Intents: one transaction commits, one aborts.
    txn_rows = mixed_rows(ps, 12, 0, 4)

    def intents(txn):
        def body(side, _ht):
            rows = (t_wire.encode_rows(txn_rows) if side == "port"
                    else j_wire.encode_rows(jax_rows(txn_rows)))
            return {"txn_id": txn, "status_tablet": "st-1", "priority": 5,
                    "read_ht": 0, "rows": rows}
        return body

    rep.send("intents", intents("txn-commit"))
    rep.send("intents", intents("txn-abort"))
    assert pair.t.participant.stats() == pair.j.participant.stats()
    assert pair.t.point_serve([b"k"], MAX_HT, 2) is None  # intents pending
    commit_ht = rep.next_ht()
    rep.send("apply_intents", lambda _s, _h: {"txn_id": "txn-commit",
                                              "commit_ht": commit_ht})
    rep.send("remove_intents", lambda _s, _h: {"txn_id": "txn-abort"})
    assert pair.t.participant.stats() == pair.j.participant.stats() == {
        "txns_with_intents": 0, "intent_keys": 0}
    state_checks(pair, ps, "intents")
    # The restart: the flushed runs load, the rest replays.
    replayed = pair.reopen()
    assert replayed == 0  # every write since the flush was an intent op
    state_checks(pair, ps, "restart")
    # ALTER (ADD COLUMN), then writes that set the new column.
    new_p = ps.with_added_column("e", TType.INT64)
    new_j = js.with_added_column("e", JType.INT64)
    rep.send("alter_schema", lambda side, _h: {
        "schema": (new_p if side == "port" else new_j).to_dict()})
    assert pair.t.meta.schema.version == new_p.version
    rows4 = mixed_rows(new_p, 25, 0, 5)
    eid = new_p.column("e").col_id
    for i, r in enumerate(rows4):
        if not r.tombstone:
            r.columns[eid] = i * 3
    rep.send("write", wire_body(rows4))
    state_checks(pair, new_p, "alter")
    # Snapshots: create, overwrite, restore, delete.
    rep.send("create_snapshot", lambda _s, _h: {"snapshot_id": "s1"})
    rep.send("write", wire_body(mixed_rows(new_p, 30, 0, 6)))
    state_checks(pair, new_p, "after snapshot")
    rep.send("restore_snapshot", lambda _s, _h: {"snapshot_id": "s1"})
    state_checks(pair, new_p, "restored")
    rep.send("delete_snapshot", lambda _s, _h: {"snapshot_id": "s1"})
    assert pair.t.list_snapshots() == pair.j.list_snapshots() == []
    rep.send("split_seal", lambda _s, _h: {})
    assert pair.t.meta.split_sealed and pair.j.meta.split_sealed
    # A second restart replays the whole tail (nothing flushed since).
    replayed = pair.reopen()
    assert replayed == 2  # the two writes since the flush
    assert pair.t.meta.split_sealed
    state_checks(pair, new_p, "second restart")
    pair.both(lambda t: t.flush())
    state_checks(pair, new_p, "flushed")
    pair.close()


@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
def test_write_path_extras(tmp_path, jax_engine):
    """``if_not_exists``, counter increments, the read fence's deadline,
    wire pages and ``point_serve`` (the port always falls back)."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    pair = Pair(tmp_path, "t6", js, ps, jax_engine)
    RV = PORT.row_version.RowVersion
    cid = {c.name: c.col_id for c in ps.value_columns}
    rows = mixed_rows(ps, 80, 0, 9)
    for i in range(0, 80, 20):
        pair.write(rows[i:i + 20])
    k = kv_key(PORT, ps, "new", 0)
    pair.write([RV(k, ht=0, liveness=True, columns={cid["a"]: 1})],
               if_not_exists=True)
    with pytest.raises(AlreadyPresent):
        pair.t.write([RV(k, ht=0, liveness=True, columns={cid["a"]: 2})],
                     if_not_exists=True)
    from yugabyte_db_tpu.utils.status import AlreadyPresent as JPresent
    with pytest.raises(JPresent):
        pair.j.write(jax_rows([RV(k, ht=0, liveness=True,
                                  columns={cid["a"]: 2})]),
                     if_not_exists=True)
    pair.write([RV(k, ht=0, increments={cid["a"]: 41})])
    assert pair.t.current_row_values(k)["a"] == 42
    pair.both(lambda t: t.flush())
    pair.write([RV(k, ht=0, increments={cid["a"]: -2})])
    assert pair.t.current_row_values(k) == pair.j.current_row_values(k)
    state_checks(pair, ps, "extras")
    assert pair.t.point_serve([k], MAX_HT, cid["a"]) is None
    with pytest.raises(DeadlineExpired):
        pair.t.scan(T.ScanSpec(read_ht=pair.t.read_time().value),
                    deadline=Deadline.after(-1.0))
    got = pair.t.scan_wire(T.ScanSpec(read_ht=MAX_HT, limit=5), "pg")
    want = pair.j.scan_wire(J.ScanSpec(read_ht=MAX_HT, limit=5), "pg")
    assert bytes(got.data) == bytes(want.data)
    pair.t.compact()
    pair.j.compact()
    state_checks(pair, ps, "compacted")
    pair.close()


# -- a directory the JAX tablet wrote --------------------------------------

def test_opens_a_directory_the_jax_tablet_wrote(tmp_path):
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    jmeta = JT.TabletMetadata("t7", "t", js, 0, 65536, engine="cpu")
    clock = JClock(now_micros=lambda: NOW_US)
    jt = JT.Tablet.create(jmeta, str(tmp_path / "jax"), clock=clock,
                          fsync=False)
    rows = mixed_rows(ps, 200, 0, 11)
    for i in range(0, 120, 30):
        jt.write(jax_rows(rows[i:i + 30]))
    jt.flush()
    jt.snapshot_op("create_snapshot", "snap")
    for i in range(120, 200, 40):
        jt.write(jax_rows(rows[i:i + 40]))
    jt.close()
    # The copy: only its metadata's engine field changes.
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    meta_path = tmp_path / "port" / "t7" / "tablet-meta.json"
    meta = json.loads(meta_path.read_text())
    meta["engine"] = "gpu"
    meta_path.write_text(json.dumps(meta))
    pair = Pair.__new__(Pair)
    pair.root, pair.tid, pair.jax_engine = tmp_path, "t7", "cpu"
    pair.kw = dict(rows_per_block=2048, consensus_managed=False)
    pair.j = JT.Tablet.open("t7", str(tmp_path / "jax"),
                            clock=JClock(now_micros=lambda: NOW_US),
                            fsync=False)
    pair.t = TT.Tablet.open("t7", str(tmp_path / "port"),
                            clock=TClock(now_micros=lambda: NOW_US),
                            fsync=False, engine_options={"device": "cpu"})
    assert pair.t._replayed_on_bootstrap == pair.j._replayed_on_bootstrap \
        == 2
    assert pair.t.engine.stats()["num_runs"] == 1
    state_checks(pair, ps, "opened")
    pair.both(lambda t: t.snapshot_op("restore_snapshot", "snap"))
    state_checks(pair, ps, "restored")
    pair.write(rows[:10])
    pair.both(lambda t: t.flush())
    state_checks(pair, ps, "written")
    pair.close()
