"""The ``gpu`` engine's tablet seam against the JAX package's engines.

The methods the tablet calls beyond scans and flushes (``apply_block``,
``dump_entries``, ``restore_entries``, ``alter_schema``, the ``data_dir``
persistence, ``scan_batch``'s ``deadline`` and ``scan_batch_wire``), each
on the same rows as the JAX ``tpu`` and ``cpu`` engines, under
``plane_encoding`` "off" and "auto" (``plane_encoding``: both packages
run the same deployment). The port runs on CPU tensors (the plain
versions of its kernels); the JAX ``tpu`` engine as its own tests run it,
on the CPU backend. Tolerance: integers, strings, counts, file bytes and
wire bytes exact; DOUBLE values within ``tests/test_engine_diff.py``'s
rel/abs 1e-4 (none of these tests sums a FLOAT column).

Mirrors ``tests/test_alter.py:53`` (``test_engine_alter_schema``) and
``tests/test_residency.py:251`` (``test_alter_keeps_runs_managed``).
"""

from __future__ import annotations

import gc
import os
import time

import pytest

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.residency as j_res
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
import yugabyte_db_tpu_torch.storage.residency as t_res
from test_torch_data import (JAX, MAX_HT, PORT, encode_key, flat_rows,
                             jax_rows, make_schema, multiversion_rows,
                             plane_encoding)
from yugabyte_db_tpu.models.datatypes import DataType as JType
from yugabyte_db_tpu.utils.flags import FLAGS as J_FLAGS
from yugabyte_db_tpu.utils.retry import Deadline as JDeadline
from yugabyte_db_tpu.utils.retry import DeadlineExpired as JExpired
from yugabyte_db_tpu_torch.models.datatypes import DataType as TType
from yugabyte_db_tpu_torch.storage import rowblock
from yugabyte_db_tpu_torch.storage.breaker import CLOSED, HALF_OPEN
from yugabyte_db_tpu_torch.utils.flags import FLAGS as T_FLAGS
from yugabyte_db_tpu_torch.utils.retry import Deadline, DeadlineExpired
from yugabyte_db_tpu_torch.utils.status import Code

ENCODINGS = ["off", "auto"]


def engines(table: str, tmp=None, rows_per_block: int = 32) -> tuple:
    """(port schema, JAX schema, {"cpu", "tpu", "gpu"} engines); with
    ``tmp``, each engine's runs are saved under ``tmp / name``."""
    ps, js = make_schema(PORT, table), make_schema(JAX, table)

    def opts(name, **kw):
        if tmp is not None:
            kw["data_dir"] = str(tmp / name)
        return kw

    e = {"cpu": J.make_engine("cpu", js, opts("cpu")),
         "tpu": J.make_engine("tpu", js, opts(
             "tpu", rows_per_block=rows_per_block)),
         "gpu": T.make_engine("gpu", ps, opts(
             "gpu", rows_per_block=rows_per_block, device="cpu"))}
    return ps, js, e


def apply(e, rows):
    for name, eng in e.items():
        eng.apply(rows if name == "gpu" else jax_rows(rows))


def spec_of(S, kw):
    k = dict(kw)
    k["aggregates"] = ([S.AggSpec(*a) for a in kw["aggregates"]]
                       if kw.get("aggregates") else None)
    k["predicates"] = [S.Predicate(*p) for p in kw.get("predicates", [])]
    return S.ScanSpec(**k)


def same_rows(got, want, label):
    assert got.columns == want.columns, label
    assert len(got.rows) == len(want.rows), label
    for gr, wr in zip(got.rows, want.rows):
        for g, w in zip(gr, wr):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-4, abs=1e-4), label
            else:
                assert g == w, label
    assert got.resume_key == want.resume_key, label


def check_battery(e, battery, against=("cpu", "tpu")):
    gpu = e["gpu"]
    got = gpu.scan_batch([spec_of(T, kw) for kw in battery])
    for name in against:
        want = e[name].scan_batch([spec_of(J, kw) for kw in battery])
        for kw, g, w in zip(battery, got, want):
            same_rows(g, w, (name, kw))
    st = gpu.stats()
    assert st["host_reserves"] == 0
    assert st["breaker"] == {"state": CLOSED, "trips": 0}


def battery(schema, read_ht=MAX_HT) -> list:
    lo, hi = encode_key(PORT, schema, 20), encode_key(PORT, schema, 200)
    aggs = [("count", None), ("sum", "a"), ("min", "a"), ("max", "d")]
    return [
        dict(read_ht=read_ht),
        dict(read_ht=read_ht, aggregates=aggs),
        dict(read_ht=read_ht, aggregates=aggs, predicates=[("d", ">=", 0)]),
        dict(read_ht=read_ht, predicates=[("a", "<", 0)], limit=17),
        dict(read_ht=read_ht, lower=min(lo, hi), upper=max(lo, hi)),
        dict(read_ht=read_ht, lower=lo, upper=lo + b"\x00"),
    ]


def entries_fields(entries) -> list:
    return [(k, [(v.key, v.ht, v.tombstone, v.liveness, v.columns,
                  v.expire_ht, v.write_id) for v in vs])
            for k, vs in entries]


def close_all(e):
    for eng in e.values():
        eng.close()


@pytest.fixture
def budget_flag():
    """Restore both packages' budget flags around a test (the caches are
    process-wide and shared by a worker's tests)."""
    gc.collect()
    j_res.hbm_cache().evict_unpinned()
    t_res.hbm_cache().evict_unpinned()
    old = J_FLAGS.get("tpu_hbm_budget_bytes"), \
        T_FLAGS.get("gpu_hbm_budget_bytes")

    def set_budget(nbytes):
        J_FLAGS.set("tpu_hbm_budget_bytes", int(nbytes))
        T_FLAGS.set("gpu_hbm_budget_bytes", int(nbytes))

    yield set_budget
    J_FLAGS.set("tpu_hbm_budget_bytes", old[0])
    T_FLAGS.set("gpu_hbm_budget_bytes", old[1])
    gc.collect()
    j_res.hbm_cache().evict_unpinned()
    t_res.hbm_cache().evict_unpinned()


# -- apply_block, dump_entries, restore_entries -----------------------------

@pytest.mark.parametrize("encoding", ENCODINGS)
def test_apply_block_dump_and_restore(encoding):
    with plane_encoding(encoding):
        ps, _js, e = engines("bench")
        rows, ht = multiversion_rows(PORT, ps, n=700, nkeys=150)
        # One block's bytes go to every engine (the port's encoder gives
        # the JAX one's bytes: test_torch_wal.py).
        for i in range(0, 500, 125):
            block = rowblock.encode_rows(rows[i:i + 125])
            for eng in e.values():
                eng.apply_block(block)
        for eng in e.values():
            eng.flush()
        for eng in e.values():
            eng.apply_block(rowblock.encode_rows(rows[500:]))
        check_battery(e, battery(ps) + battery(ps, ht - 150))
        for eng in e.values():
            eng.flush()
        dumped = {n: eng.dump_entries() for n, eng in e.items()}
        assert entries_fields(dumped["gpu"]) == \
            entries_fields(dumped["tpu"]) == entries_fields(dumped["cpu"])
        # Restore an earlier state: the first 300 writes.
        mem = PORT.memtable.MemTable()
        mem.apply(rows[:300])
        first = mem.drain_sorted()
        jmem = JAX.memtable.MemTable()
        jmem.apply(jax_rows(rows[:300]))
        jfirst = jmem.drain_sorted()
        for n, eng in e.items():
            eng.apply(rows[300:310] if n == "gpu"
                      else jax_rows(rows[300:310]))  # a live memtable too
            eng.restore_entries(first if n == "gpu" else jfirst)
        assert e["gpu"].stats()["num_runs"] == 1
        assert e["gpu"].stats()["memtable_versions"] == 0
        check_battery(e, battery(ps))
        assert entries_fields(e["gpu"].dump_entries()) == \
            entries_fields(e["tpu"].dump_entries())
        for eng in e.values():
            eng.restore_entries([])
        assert e["gpu"].dump_entries() == []
        check_battery(e, battery(ps))
        close_all(e)


# -- alter_schema -----------------------------------------------------------

def alter_engines(encoding):
    """``tests/test_alter.py:53``'s table on the three engines."""
    def schema(S):
        return S.Schema([
            S.ColumnSchema("k", S.DataType.STRING, S.ColumnKind.HASH),
            S.ColumnSchema("a", S.DataType.INT64),
            S.ColumnSchema("b", S.DataType.STRING)], table_id="t")

    ps, js = schema(PORT.schema), schema(JAX.schema)
    e = {"cpu": J.make_engine("cpu", js, {"rows_per_block": 8}),
         "tpu": J.make_engine("tpu", js, {"rows_per_block": 8}),
         "gpu": T.make_engine("gpu", ps, {"rows_per_block": 8,
                                          "device": "cpu"})}
    return ps, js, e


def alter_key(schema, i):
    return schema.encode_primary_key(
        {"k": f"u{i:03d}"},
        PORT.partition.compute_hash_code(schema, {"k": f"u{i:03d}"}))


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_engine_alter_schema(encoding):
    RowVersion = PORT.row_version.RowVersion
    with plane_encoding(encoding):
        ps, js, e = alter_engines(encoding)
        cid = {c.name: c.col_id for c in ps.columns}
        apply(e, [RowVersion(alter_key(ps, i), ht=10 + i, liveness=True,
                             columns={cid["a"]: i, cid["b"]: f"s{i}"})
                  for i in range(40)])
        for eng in e.values():
            eng.flush()
        # An aggregate and a page before the ALTER: the runs are resident,
        # the encoded ones with their side-car.
        check_battery(e, [dict(read_ht=10_000, aggregates=[
            ("count", None), ("sum", "a")], predicates=[("b", ">=", "s2")]),
            dict(read_ht=10_000, limit=5)])
        new_p = ps.with_added_column("c", TType.INT64)
        new_j = js.with_added_column("c", JType.INT64)
        for n, eng in e.items():
            eng.alter_schema(new_p if n == "gpu" else new_j)
        ncid = new_p.column("c").col_id
        apply(e, [RowVersion(alter_key(ps, i), ht=100 + i, liveness=True,
                             columns={cid["a"]: -i, ncid: i * 7})
                  for i in range(40, 50)])
        for eng in e.values():
            eng.flush()
        res = e["gpu"].scan(T.ScanSpec(read_ht=10_000,
                                       projection=["k", "a", "c"]))
        got = {r[0]: (r[1], r[2]) for r in res.rows}
        assert got["u005"] == (5, None)
        assert got["u045"] == (-45, 45 * 7)
        alter_battery = [
            dict(read_ht=10_000, projection=["k", "a", "c"]),
            dict(read_ht=10_000, predicates=[("c", ">=", 301)],
                 projection=["k", "c"]),
            dict(read_ht=10_000, aggregates=[("count", None), ("sum", "c"),
                                             ("max", "c"), ("count", "c")]),
            dict(read_ht=10_000, aggregates=[("count", None)],
                 predicates=[("b", "<", "s3")]),
        ]
        check_battery(e, alter_battery)
        res = e["gpu"].scan(T.ScanSpec(read_ht=10_000,
                                       predicates=[T.Predicate("c", ">=",
                                                               301)],
                                       projection=["k", "c"]))
        assert sorted(r[0] for r in res.rows) == [f"u{i:03d}"
                                                  for i in range(43, 50)]
        # A dropped column disappears from scans; its id is retired.
        s2p, s2j = new_p.with_dropped_column("b"), new_j.with_dropped_column(
            "b")
        for n, eng in e.items():
            eng.alter_schema(s2p if n == "gpu" else s2j)
        res = e["gpu"].scan(T.ScanSpec(read_ht=10_000))
        assert "b" not in res.columns
        check_battery(e, [dict(read_ht=10_000)] + alter_battery[:3])
        close_all(e)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_alter_keeps_runs_managed(encoding, budget_flag):
    """``tests/test_residency.py:251``: ALTER drops each live run's stale
    payload but keeps its residency registration; the re-upload is a
    managed miss, charged to the cache, and the budget holds."""
    with plane_encoding(encoding):
        ps, js, e = engines("residency", rows_per_block=32)
        RowVersion = PORT.row_version.RowVersion
        cids = {c.name: c.col_id for c in ps.value_columns}
        ht = 0
        for f in range(2):
            rows = []
            for i in range(120):
                ht += 1
                rows.append(RowVersion(
                    encode_key(PORT, ps, (f * 7 + i) % 211), ht=ht,
                    liveness=True,
                    columns={cids["a"]: i - 50, cids["b"]: f"v{f}-{i % 9}",
                             cids["c"]: i * 0.25 - 3.0}))
            apply(e, rows)
            for eng in e.values():
                eng.flush()
        gpu = e["gpu"]
        check_battery(e, [dict(read_ht=MAX_HT, aggregates=[
            ("count", None), ("sum", "a")])])  # resident, side-cars made
        budget = max(int(sum(t._nbytes_hint() for t in gpu.runs) * 0.5), 1)
        budget_flag(budget)
        cache = t_res.hbm_cache()
        new_p = ps.with_added_column("d", TType.INT64)
        new_j = js.with_added_column("d", JType.INT64)
        for n, eng in e.items():
            eng.alter_schema(new_p if n == "gpu" else new_j)
        for t in gpu.runs:
            entry = cache._entries[t._res_key]  # the registration survives
            assert entry.payload is None and entry.aux == {}
            assert t.sidecar_nbytes == 0 and t.held_view() is None
            assert t.crun.enc_stats is None
        misses = cache.stats()["misses"]
        before = cache.stats()["demand_upload_bytes"]
        check_battery(e, [
            dict(read_ht=MAX_HT),
            dict(read_ht=MAX_HT, aggregates=[("count", None), ("sum", "a"),
                                             ("min", "a"), ("max", "a"),
                                             ("count", "d")]),
            dict(read_ht=MAX_HT, predicates=[("a", ">", 0)])])
        stats = cache.stats()
        assert stats["demand_upload_bytes"] > before
        assert stats["misses"] >= misses + len(gpu.runs)
        gpu.runs[0].pin()
        try:
            assert cache._entries[gpu.runs[0]._res_key].payload is not None
            assert gpu.runs[0].dev.arrays["cols"].keys() >= {
                new_p.column("d").col_id}
        finally:
            gpu.runs[0].unpin()
        gc.collect()
        cache.evict_unpinned()
        assert cache.resident_bytes() <= budget + cache.pinned_bytes()
        close_all(e)


def test_release_matches_jax_cache():
    """``HbmCache.release`` against the JAX cache's: the payload and its
    aux values go, the registration and the counters stay, and the next
    acquire is a charged miss."""
    import numpy as np

    sides = []
    for res in (j_res, t_res):
        cache = res.HbmCache()
        owner = type("Owner", (), {})()
        key = cache.register(owner)
        base = dict(cache.stats())
        cache.acquire(key, lambda: (np.zeros(64, np.uint8), 64))
        cache.aux_put(key, "side", np.zeros(16, np.uint8), 16)
        cache.release(key)
        assert key in cache._entries
        assert cache._entries[key].payload is None
        assert cache.aux_get(key, "side") is None
        after_release = cache.resident_bytes()
        cache.acquire(key, lambda: (np.zeros(32, np.uint8), 32))
        st = cache.stats()
        sides.append((after_release, cache.resident_bytes(),
                      st["misses"] - base["misses"],
                      st["hits"] - base["hits"], owner))
    assert sides[0][:4] == sides[1][:4] == (0, 32, 2, 0)


# -- persistence ------------------------------------------------------------

def run_file_bytes(d) -> list:
    return [(n, open(os.path.join(d, n), "rb").read())
            for n in sorted(os.listdir(d))]


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_runs_persist_byte_equal_to_jax(tmp_path, encoding):
    with plane_encoding(encoding):
        ps, js, e = engines("rows", tmp=tmp_path)
        rows, ht = flat_rows(PORT, ps, 400, seed=13)
        apply(e, rows[:250])
        for eng in e.values():
            eng.flush()  # the gpu engine: the device route (K12's plain)
        apply(e, rows[250:])
        for eng in e.values():
            eng.flush()
        assert e["gpu"].stats()["flush_paths"]["device"] == 2
        # The files the device flush saved are the JAX engine's, byte for
        # byte (its runs' rows are the memtable's versions).
        assert run_file_bytes(tmp_path / "gpu") == \
            run_file_bytes(tmp_path / "tpu")
        bat = battery(ps) + battery(ps, ht - 200)
        check_battery(e, bat)
        # A fresh engine on each directory answers the same.
        fresh = {"cpu": J.make_engine("cpu", js,
                                      {"data_dir": str(tmp_path / "cpu")}),
                 "tpu": J.make_engine("tpu", js, {
                     "rows_per_block": 32,
                     "data_dir": str(tmp_path / "tpu")}),
                 "gpu": T.make_engine("gpu", ps, {
                     "rows_per_block": 32, "device": "cpu",
                     "data_dir": str(tmp_path / "gpu")})}
        assert fresh["gpu"].stats()["num_runs"] == 2
        assert fresh["gpu"].stats()["flushed_frontier_ht"] == \
            e["gpu"].stats()["flushed_frontier_ht"]
        check_battery(fresh, bat)
        # Compaction replaces every file with the merged run's.
        for eng in e.values():
            eng.compact(ht - 100)
        assert run_file_bytes(tmp_path / "gpu") == \
            run_file_bytes(tmp_path / "tpu")
        assert len(os.listdir(tmp_path / "gpu")) == 1
        again = T.make_engine("gpu", ps, {"rows_per_block": 32,
                                          "device": "cpu",
                                          "data_dir": str(tmp_path / "gpu")})
        check_battery({"gpu": again, "cpu": e["cpu"], "tpu": e["tpu"]},
                      battery(ps))
        close_all(e)
        close_all(fresh)
        again.close()


def test_host_flush_route_persists_too(tmp_path, monkeypatch):
    """A key past the prefix planes sends the flush to the host build:
    its file is the JAX engine's for the same memtable too."""
    ps, js, e = engines("bench", tmp=tmp_path)
    RowVersion = PORT.row_version.RowVersion
    cids = {c.name: c.col_id for c in ps.value_columns}
    long_key = ps.encode_primary_key(
        {"k": "x" * 60, "r": 1},
        PORT.partition.compute_hash_code(ps, {"k": "x" * 60}))
    rows, _ = flat_rows(PORT, ps, 60, seed=2)
    rows.append(RowVersion(long_key, ht=10_000, liveness=True,
                           columns={cids["a"]: 5}))
    apply(e, rows)
    for eng in e.values():
        eng.flush()
    assert e["gpu"].stats()["flush_paths"] == {"device": 0, "host": 1}
    assert run_file_bytes(tmp_path / "gpu") == \
        run_file_bytes(tmp_path / "tpu")
    close_all(e)


# -- deadlines --------------------------------------------------------------

@pytest.mark.parametrize("encoding", ENCODINGS)
def test_expired_deadline_times_out_without_reserve(encoding):
    with plane_encoding(encoding):
        ps, _js, e = engines("bench")
        rows, _ = flat_rows(PORT, ps, 300, seed=3)
        apply(e, rows)
        for eng in e.values():
            eng.flush()
        gpu, tpu = e["gpu"], e["tpu"]
        specs = battery(ps)
        # Expired before the batch: nothing is issued, on either side.
        with pytest.raises(DeadlineExpired) as got:
            gpu.scan_batch([spec_of(T, kw) for kw in specs],
                           deadline=Deadline.after(-1.0))
        with pytest.raises(JExpired) as want:
            tpu.scan_batch([spec_of(J, kw) for kw in specs],
                           deadline=JDeadline.after(-1.0))
        assert got.value.status.code == Code.TIMED_OUT
        assert int(got.value.status.code) == int(want.value.status.code)
        # Expired between the launches and finish(): the pins go, nothing
        # is re-served, and the breaker does not count it (it is not a
        # device fault).
        cache = t_res.hbm_cache()
        pinned0 = cache.pinned_bytes()
        batch = gpu.scan_batch_async([spec_of(T, kw) for kw in specs],
                                     deadline=Deadline(time.monotonic()
                                                       + 0.05))
        assert batch.pins and cache.pinned_bytes() > pinned0
        time.sleep(0.1)
        with pytest.raises(DeadlineExpired):
            batch.finish()
        assert batch.pins == [] and cache.pinned_bytes() == pinned0
        st = gpu.stats()
        assert st["host_reserves"] == 0
        assert st["breaker"]["state"] == CLOSED
        assert st["breaker"]["trips"] == 0
        assert gpu.breaker.consecutive_failures == 0
        # While the breaker is open the host serve checks the deadline
        # before each spec too.
        gpu.breaker.trip()
        batch = gpu.scan_batch_async([spec_of(T, kw) for kw in specs],
                                     deadline=Deadline(time.monotonic()
                                                       + 0.05))
        time.sleep(0.1)
        with pytest.raises(DeadlineExpired):
            batch.finish()
        gpu.breaker.reset()
        # A live deadline serves the batch as usual.
        got = gpu.scan_batch([spec_of(T, kw) for kw in specs],
                             deadline=Deadline.after(60.0))
        want = e["cpu"].scan_batch([spec_of(J, kw) for kw in specs])
        for kw, g, w in zip(specs, got, want):
            same_rows(g, w, kw)
        close_all(e)


def test_expired_deadlines_in_a_row_do_not_open_the_breaker():
    """``failure_threshold`` batches in a row whose deadline runs out in
    ``finish`` leave the breaker closed with no trip and no host
    re-serve; an expired deadline in a half-open probe frees the probe's
    slot, and the next batch probes and closes the breaker."""
    ps, js = make_schema(PORT, "bench"), make_schema(JAX, "bench")
    gpu = T.make_engine("gpu", ps, {"rows_per_block": 32,
                                     "device": "cpu",
                                     "breaker_failure_threshold": 2,
                                     "breaker_cooldown_s": 0.05})
    cpu = J.make_engine("cpu", js, {})
    rows, _ = flat_rows(PORT, ps, 300, seed=5)
    apply({"gpu": gpu, "cpu": cpu}, rows)
    gpu.flush()
    cpu.flush()
    specs = battery(ps)

    def expire_in_finish():
        batch = gpu.scan_batch_async([spec_of(T, kw) for kw in specs],
                                     deadline=Deadline(time.monotonic()
                                                       + 0.05))
        assert isinstance(batch, T.gpu_engine._AsyncBatch)
        time.sleep(0.1)
        with pytest.raises(DeadlineExpired):
            batch.finish()

    for _ in range(gpu.breaker.failure_threshold + 1):
        expire_in_finish()
    st = gpu.stats()
    assert st["breaker"] == {"state": CLOSED, "trips": 0}
    assert gpu.breaker.consecutive_failures == 0
    assert st["host_reserves"] == 0
    # Half-open: the admitted probe's deadline runs out, its slot is
    # freed, and the next batch is admitted as the probe and closes.
    gpu.breaker.trip()
    time.sleep(0.06)
    expire_in_finish()
    assert gpu.breaker.state == HALF_OPEN
    got = gpu.scan_batch([spec_of(T, kw) for kw in specs])
    assert gpu.breaker.state == CLOSED
    assert gpu.stats()["host_reserves"] == 0
    want = cpu.scan_batch([spec_of(J, kw) for kw in specs])
    for kw, g, w in zip(specs, got, want):
        same_rows(g, w, kw)
    gpu.close()


# -- wire pages -------------------------------------------------------------

def wire_specs(schema, read_ht) -> list:
    lo = encode_key(PORT, schema, 30)
    out = [dict(read_ht=read_ht, limit=100),
           dict(read_ht=read_ht, limit=7, predicates=[("d", ">=", 0)]),
           dict(read_ht=read_ht, limit=50, lower=lo,
                projection=["k", "r", "a", "c"]),
           dict(read_ht=read_ht, lower=lo, upper=lo + b"\x00"),
           dict(read_ht=read_ht, predicates=[("a", "<", 0)]),
           dict(read_ht=read_ht, aggregates=[("count", None), ("sum", "d"),
                                             ("max", "a")])]
    for i in (3, 77, 150):
        k = encode_key(PORT, schema, i)
        out.append(dict(read_ht=read_ht, lower=k, upper=k + b"\x00",
                        projection=["a", "c", "d"], limit=1))
    return out


def assert_same_pages(got, want, label):
    assert len(got) == len(want)
    assert sum(p.nrows for p in got) > 0 and all(p.data for p in got
                                                  if p.nrows)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.columns == w.columns, (label, i)
        assert (g.nrows, g.resume) == (w.nrows, w.resume), (label, i)
        assert bytes(g.data) == bytes(w.data), (label, i)


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("fmt", ["cql", "pg"])
def test_scan_batch_wire_bytes_equal_jax(encoding, fmt):
    with plane_encoding(encoding):
        ps, _js, e = engines("bench")
        rows, ht = flat_rows(PORT, ps, 300, seed=21)
        apply(e, rows)
        for eng in e.values():
            eng.flush()
        read = ht + 1
        specs = wire_specs(ps, read)
        # One flat run: the JAX engine's native wire page server where it
        # builds here, and its point-get path.
        got = e["gpu"].scan_batch_wire([spec_of(T, kw) for kw in specs], fmt)
        for name in ("tpu", "cpu"):
            assert_same_pages(got, e[name].scan_batch_wire(
                [spec_of(J, kw) for kw in specs], fmt), (name, "flat"))
        # Several sources: a second run of updates and a live memtable.
        ups, ht2 = multiversion_rows(PORT, ps, n=200, nkeys=120, seed=8)
        shifted = [PORT.row_version.RowVersion(
            r.key, ht=r.ht + ht, tombstone=r.tombstone,
            liveness=r.liveness, columns=dict(r.columns),
            expire_ht=(r.expire_ht + ht if r.expire_ht != MAX_HT
                       else MAX_HT)) for r in ups]
        apply(e, shifted[:120])
        for eng in e.values():
            eng.flush()
        apply(e, shifted[120:])
        specs = wire_specs(ps, ht2 + ht + 1) + wire_specs(ps, read)
        got = e["gpu"].scan_batch_wire([spec_of(T, kw) for kw in specs], fmt)
        for name in ("tpu", "cpu"):
            assert_same_pages(got, e[name].scan_batch_wire(
                [spec_of(J, kw) for kw in specs], fmt), (name, "sources"))
        assert e["gpu"].point_serve([encode_key(PORT, ps, 3)], read,
                                    ps.value_columns[0].col_id) is None
        close_all(e)
