"""The port's host byte formats against the JAX package's.

The codec, the wire row lists, the row block, the run files and the WAL
segments of ``yugabyte_db_tpu_torch`` are copies of the JAX package's
modules: for the same rows each must give the same bytes, and each side
must read the other's. Rows come from ``test_torch_data``'s tables (every
datatype there: STRING, INT64, INT32, DOUBLE, FLOAT), with NULLs,
tombstones, TTLs (absolute and relative) and intra-batch write ids. The
JAX side runs its native codec and row-block modules where they build,
and its pure-Python twins always. Tolerance: none, every byte exact.

The second half mirrors ``tests/test_tablet.py``'s WAL and MVCC tests
against the port's ``Log`` and ``MvccManager``.
"""

from __future__ import annotations

import datetime
import decimal
import os
import random
import threading
import uuid

import pytest

import test_torch_data as D
from yugabyte_db_tpu.storage import rowblock as j_rowblock
from yugabyte_db_tpu.storage import run_io as j_run_io
from yugabyte_db_tpu.storage import wire as j_wire
from yugabyte_db_tpu.storage.row_version import RowVersion as JRow
from yugabyte_db_tpu.tablet import wal as j_wal
from yugabyte_db_tpu.utils import codec as j_codec
from yugabyte_db_tpu_torch.storage import rowblock as t_rowblock
from yugabyte_db_tpu_torch.storage import run_io as t_run_io
from yugabyte_db_tpu_torch.storage import wire as t_wire
from yugabyte_db_tpu_torch.storage.row_version import RowVersion as TRow
from yugabyte_db_tpu_torch.tablet import Log, LogEntry, MvccManager, OpId
from yugabyte_db_tpu_torch.tablet import wal as t_wal
from yugabyte_db_tpu_torch.utils import codec as t_codec
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridClock

TABLES = sorted(D.TABLES)


def port_rows(table: str, n: int = 240, seed: int = 11) -> list:
    """``flat_rows`` of ``table`` in the port's classes, with a relative
    TTL on some live rows and intra-batch write ids."""
    schema = D.make_schema(D.PORT, table)
    rows, _ht = D.flat_rows(D.PORT, schema, n, seed)
    rng = random.Random(seed)
    out = []
    for i, r in enumerate(rows):
        ttl = (rng.randrange(1, 10**9) if not r.tombstone
               and rng.random() < 0.1 else None)
        out.append(TRow(r.key, ht=r.ht, tombstone=r.tombstone,
                        liveness=r.liveness, columns=dict(r.columns),
                        expire_ht=r.expire_ht, ttl_us=ttl, write_id=i % 5))
    return out


def as_jax(rows: list) -> list:
    """The JAX package's RowVersions of the port's ``rows``."""
    return [JRow(r.key, ht=r.ht, tombstone=r.tombstone, liveness=r.liveness,
                 columns=dict(r.columns), expire_ht=r.expire_ht,
                 ttl_us=r.ttl_us, write_id=r.write_id,
                 increments=dict(r.increments))
            for r in rows]


def fields(r) -> tuple:
    return (r.key, r.ht, r.tombstone, r.liveness, r.columns, r.expire_ht,
            r.ttl_us, r.write_id, r.increments)


CODEC_CASES = [
    None, True, False, 0, 1, -1, 2 ** 62, -(2 ** 62), 2 ** 63, 2 ** 80,
    -(2 ** 80), 1.5, -0.0, 1e308, "héllo", "", b"\x00\xff", b"",
    [1, [2, [3]]], (4, 5), {"a": 1, "b": [None, {"c": b"x"}]}, {7: -7},
    [], {}, decimal.Decimal("-12.5"), uuid.UUID(int=12345),
    datetime.date(2024, 2, 29), datetime.time(23, 59, 58, 7),
]


@pytest.mark.parametrize("i", range(len(CODEC_CASES)))
def test_codec_bytes_equal_the_jax_codec(i):
    v = CODEC_CASES[i]
    got = t_codec.encode(v)
    assert got == j_codec.encode(v) == j_codec._py_encode(v)
    want = j_codec.decode(got)
    assert t_codec.decode(got) == want
    assert t_codec.decode(j_codec.encode(v)) == want


@pytest.mark.parametrize("table", TABLES)
def test_wire_rows_bytes_equal_the_jax_wire(table):
    rows = port_rows(table)
    rows[3] = TRow(rows[3].key, ht=rows[3].ht, columns={},
                   increments={2: 5, 3: -1})
    jrows = as_jax(rows)
    body = t_codec.encode(t_wire.encode_rows(rows))
    assert body == j_codec.encode(j_wire.encode_rows(jrows))
    # Each side decodes the other's bytes into the same rows.
    mine = t_wire.decode_rows(t_codec.decode(j_codec.encode(
        j_wire.encode_rows(jrows))))
    theirs = j_wire.decode_rows(j_codec.decode(body))
    assert [fields(r) for r in mine] == [fields(r) for r in theirs] \
        == [fields(r) for r in rows]


@pytest.mark.parametrize("table", TABLES)
def test_row_block_bytes_equal_the_jax_block(table):
    rows = port_rows(table)
    jrows = as_jax(rows)
    block = t_rowblock.encode_rows(rows)
    assert block == j_rowblock.encode_rows(jrows) \
        == j_rowblock._py_encode_rows(jrows)
    assert t_rowblock.block_count(block) == len(rows)
    assert t_rowblock.block_keys(block) == j_rowblock.block_keys(block)
    assert t_rowblock.block_ht_range(block) == \
        j_rowblock.block_ht_range(block)
    assert [fields(r) for r in t_rowblock.rows_from_block(block)] == \
        [fields(r) for r in j_rowblock.rows_from_block(block)]
    # Stamping resolves relative TTLs against the commit time.
    stamped = t_rowblock.stamp_block(block, 1 << 40)
    assert stamped == j_rowblock.stamp_block(block, 1 << 40) \
        == j_rowblock._py_stamp_block(block, 1 << 40)


@pytest.mark.parametrize("table", TABLES)
def test_run_files_equal_the_jax_run_files(tmp_path, table):
    schema = D.make_schema(D.PORT, table)
    rows, _ = D.multiversion_rows(D.PORT, schema, n=400, nkeys=60) \
        if table == "bench" else D.flat_rows(D.PORT, schema, 300, seed=4)
    mem = D.PORT.memtable.MemTable()
    mem.apply(rows)
    entries = mem.drain_sorted()
    jentries = [(k, as_jax(vs)) for k, vs in entries]
    t_run_io.save_run(str(tmp_path / "port.dat"), entries)
    j_run_io.save_run(str(tmp_path / "jax.dat"), jentries)
    port_bytes = (tmp_path / "port.dat").read_bytes()
    assert port_bytes == (tmp_path / "jax.dat").read_bytes()
    mine = t_run_io.load_run(str(tmp_path / "jax.dat"))
    theirs = j_run_io.load_run(str(tmp_path / "port.dat"))
    assert [(k, [fields(v) for v in vs]) for k, vs in mine] == \
        [(k, [fields(v) for v in vs]) for k, vs in theirs]


@pytest.mark.parametrize("table", TABLES)
def test_run_records_equal_the_generic_codec(table):
    """``codec.encode_run`` gives ``codec.encode`` of the record lists,
    and ``codec.decode_run`` reads them back into the same versions
    (``RowVersion.stored``) as the generic decoder's lists."""
    from yugabyte_db_tpu_torch.storage.memtable import MemTable

    mem = MemTable()
    mem.apply(port_rows(table))
    entries = mem.drain_sorted()
    payload = [[k, [[v.ht, v.tombstone, v.liveness,
                     {str(c): x for c, x in v.columns.items()},
                     v.expire_ht, v.write_id] for v in vs]]
               for k, vs in entries]
    buf = t_codec.encode_run("run1", entries)
    assert buf == t_codec.encode(["run1", payload])
    got = t_codec.decode_run(buf, "run1", TRow.stored)
    assert [(k, [fields(v) for v in vs]) for k, vs in got] == \
        [(k, [fields(TRow(k, ht=r[0], tombstone=r[1], liveness=r[2],
                          columns={int(c): x for c, x in r[3].items()},
                          expire_ht=r[4], write_id=r[5])) for r in recs])
         for k, recs in t_codec.decode(buf)[1]]
    # Another magic, or another layout, is not read.
    assert t_codec.decode_run(buf, "run2", TRow.stored) is None


def test_stored_version_sets_every_field():
    """``RowVersion.stored`` builds the object the constructor builds,
    with every dataclass field, and keeps the tombstone rule."""
    import dataclasses

    got = TRow.stored(b"k", 7, False, True, {3: 1}, 9, 2)
    assert set(vars(got)) == {f.name for f in dataclasses.fields(TRow)}
    assert fields(got) == fields(TRow(b"k", ht=7, liveness=True,
                                      columns={3: 1}, expire_ht=9,
                                      write_id=2))
    assert fields(TRow.stored(b"k", 8, True, False, {}, 9, 0)) == \
        fields(TRow(b"k", ht=8, tombstone=True, expire_ht=9))
    with pytest.raises(ValueError, match="tombstone"):
        TRow.stored(b"k", 8, True, True, {}, 9, 0)


def test_load_run_reads_the_older_record_layout(tmp_path):
    """A run file whose records have no write id (five fields) loads
    through the generic decoder, with write id 0, in both packages."""
    ps = D.make_schema(D.PORT, "bench")
    rows, _ = D.flat_rows(D.PORT, ps, 40, 3)
    entries = sorted(((r.key, [r]) for r in rows), key=lambda e: e[0])
    payload = [[k, [[v.ht, v.tombstone, v.liveness,
                     {str(c): x for c, x in v.columns.items()},
                     v.expire_ht] for v in vs]] for k, vs in entries]
    path = tmp_path / "run-0000000000.dat"
    path.write_bytes(t_codec.encode(["run1", payload]))
    assert t_codec.decode_run(path.read_bytes(), "run1", TRow.stored) is None
    mine = t_run_io.load_run(str(path))
    theirs = j_run_io.load_run(str(path))
    want = [(k, [(v.key, v.ht, v.tombstone, v.liveness, v.columns,
                  v.expire_ht, None, 0, {}) for v in vs]) for k, vs in entries]
    assert [(k, [fields(v) for v in vs]) for k, vs in mine] == want
    assert [(k, [fields(v) for v in vs]) for k, vs in theirs] == want


def test_run_persistence_numbering_and_replace(tmp_path):
    rows = port_rows("bench", n=50)
    entries = [(r.key, [r]) for r in sorted(rows, key=lambda r: r.key)]
    p = t_run_io.RunPersistence(str(tmp_path / "runs"))
    assert p.enabled and p.files == []
    p.save_new(entries[:20])
    p.save_new(entries[20:])
    names = [os.path.basename(f) for f in p.files]
    assert names == ["run-0000000000.dat", "run-0000000001.dat"]
    # A fresh instance finds the files and numbers past them, as the
    # JAX class does on the same directory.
    q = t_run_io.RunPersistence(str(tmp_path / "runs"))
    j = j_run_io.RunPersistence(str(tmp_path / "runs"))
    assert q.files == j.files == p.files
    assert [len(e) for e in q.load_all()] == [20, 30]
    q.replace_all(entries)
    assert [os.path.basename(f) for f in q.files] == ["run-0000000002.dat"]
    assert sorted(os.listdir(tmp_path / "runs")) == ["run-0000000002.dat"]
    assert not t_run_io.RunPersistence(None).enabled


@pytest.mark.parametrize("segment_bytes", [8 * 1024 * 1024, 700])
def test_wal_segments_equal_the_jax_wal(tmp_path, segment_bytes):
    rows = port_rows("rows", n=60)
    jrows = as_jax(rows)
    bodies = [(t_wire.encode_rows(rows[i:i + 6]),
               j_wire.encode_rows(jrows[i:i + 6])) for i in range(0, 60, 6)]
    logs = {"port": Log(str(tmp_path / "port"), segment_bytes, fsync=False),
            "jax": j_wal.Log(str(tmp_path / "jax"), segment_bytes,
                             fsync=False)}
    for i, (tb, jb) in enumerate(bodies):
        logs["port"].append(LogEntry(OpId(1, i + 1), 1000 + i, "write", tb,
                                     committed=i))
        logs["jax"].append(j_wal.LogEntry(j_wal.OpId(1, i + 1), 1000 + i,
                                          "write", jb, committed=i))
        if i % 3 == 2:
            logs["port"].sync()
            logs["jax"].sync()
    for log in logs.values():
        log.close()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) > (1 if segment_bytes < 1000 else 0)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
    # Each side replays the other's log.
    mine = list(Log(str(tmp_path / "jax"), fsync=False).read_all())
    theirs = list(j_wal.Log(str(tmp_path / "port"), fsync=False).read_all())
    assert [(e.op_id.index, e.ht, e.committed) for e in mine] == \
        [(e.op_id.index, e.ht, e.committed) for e in theirs]
    assert [fields(r) for e in mine for r in t_wire.decode_rows(e.body)] \
        == [fields(r) for r in rows]


# -- tests/test_tablet.py's WAL and MVCC tests, on the port ----------------

def test_wal_roundtrip(tmp_path):
    log = Log(str(tmp_path / "wal"), fsync=False)
    for i in range(1, 21):
        log.append(LogEntry(OpId(1, i), ht=100 + i, op_type="write",
                            body=[b"key", i, {"x": [1, 2.5, None]}]))
    log.sync()
    log.close()
    log2 = Log(str(tmp_path / "wal"), fsync=False)
    entries = list(log2.read_all())
    assert [e.op_id.index for e in entries] == list(range(1, 21))
    assert entries[3].body == [b"key", 4, {"x": [1, 2.5, None]}]
    assert log2.last_appended == OpId(1, 20)


def test_wal_rejects_non_monotonic(tmp_path):
    log = Log(str(tmp_path / "wal"), fsync=False)
    log.append(LogEntry(OpId(1, 5), 1, "write", []))
    with pytest.raises(ValueError):
        log.append(LogEntry(OpId(1, 5), 2, "write", []))


def test_wal_torn_tail_recovery(tmp_path):
    log = Log(str(tmp_path / "wal"), fsync=False)
    for i in range(1, 6):
        log.append(LogEntry(OpId(1, i), i, "write", [i]))
    log.sync()
    log.close()
    path = log.segment_paths()[0]
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 3)  # a crash in the middle of a record
    entries = list(Log(str(tmp_path / "wal"), fsync=False).read_all())
    assert [e.body for e in entries] == [[1], [2], [3], [4]]
    # A corrupt record stops the replay at the last good one, too.
    with open(path, "r+b") as f:
        f.seek(10)
        f.write(b"\xff")
    assert list(Log(str(tmp_path / "wal"), fsync=False).read_all()) == []


def test_wal_segment_roll_and_gc(tmp_path):
    log = Log(str(tmp_path / "wal"), segment_bytes=256, fsync=False)
    for i in range(1, 51):
        log.append(LogEntry(OpId(1, i), i, "write", ["x" * 30]))
    log.sync()
    assert len(log.segment_paths()) > 2
    assert log.gc(min_retained_index=30) > 0
    entries = list(log.read_all(30))
    assert entries[0].op_id.index == 30
    assert entries[-1].op_id.index == 50
    assert set(range(30, 51)) <= {e.op_id.index for e in log.read_all()}


def test_wal_truncate_after(tmp_path):
    log = Log(str(tmp_path / "wal"), segment_bytes=256, fsync=False)
    for i in range(1, 31):
        log.append(LogEntry(OpId(1, i), i, "write", ["y" * 20]))
    log.sync()
    assert log.truncate_after(17) == 13
    assert log.last_appended == OpId(1, 17)
    assert [e.op_id.index for e in log.read_all()] == list(range(1, 18))
    log.append(LogEntry(OpId(2, 18), 18, "write", []))
    log.close()


def test_mvcc_safe_time_blocks_on_pending():
    clock = HybridClock(now_micros=lambda: 1000)
    m = MvccManager(clock)
    ht1 = clock.now()
    m.add_pending(ht1)
    assert m.safe_time().value == ht1.value - 1
    m.replicated(ht1)
    assert m.safe_time() >= ht1
    assert m.safe_time() >= ht1  # observing issues no hybrid time
    assert m.last_replicated_ht == ht1
    ht2 = clock.now()
    m.add_pending(ht2)
    m.aborted(ht2)
    assert m.safe_time() >= ht2
    with pytest.raises(ValueError):
        m.replicated(ht2)


def test_mvcc_wait_for_safe_time():
    clock = HybridClock(now_micros=lambda: 1000)
    m = MvccManager(clock)
    ht = clock.now()
    m.add_pending(ht)
    assert m.wait_for_safe_time(ht, timeout=0.01) is False
    done = []

    def waiter():
        done.append(m.wait_for_safe_time(ht, timeout=5))

    t = threading.Thread(target=waiter)
    t.start()
    m.replicated(ht)
    t.join(timeout=5)
    assert done == [True]


def test_hybrid_clock_matches_the_jax_clock():
    from yugabyte_db_tpu.utils.hybrid_time import (HybridClock as JClock,
                                                   HybridTime as JTime)
    from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime

    ticks = [5, 5, 5, 9, 7, 12]
    mine = iter(ticks)
    theirs = iter(ticks)
    a = HybridClock(now_micros=lambda: next(mine))
    b = JClock(now_micros=lambda: next(theirs))
    seq = []
    for i in range(len(ticks)):
        if i == 3:
            a.update(HybridTime((40 << 12) + 3))
            b.update(JTime((40 << 12) + 3))
        x, y = a.now(), b.now()
        seq.append(x.value)
        assert (x.value, x.physical_micros, x.logical) == \
            (y.value, y.physical_micros, y.logical)
    assert seq == sorted(seq) and len(set(seq)) == len(seq)
    assert repr(HybridTime(0)) == "HT<min>"
