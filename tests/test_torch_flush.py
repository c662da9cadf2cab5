"""The device flush of the ``gpu`` engine against the JAX package's.

``replay_flush_plain`` (K12's plain version) must equal the JAX
``replay_flush`` on the CPU, pad entries included; a device-flushed run
must equal the host build of the same memtable plane for plane (and the
JAX ``tpu`` engine's device-flushed run), and its adopted device planes
the upload of that host build (``DeviceRun(crun)``); scans must give the
JAX ``cpu`` engine's answers; same-hybrid-time writes must order by write
id; and the ineligible flushes (a key past the prefix planes, a key group
longer than a block, a value the encoders reject) must take the host
route as the JAX engine's do. Mirrors ``tests/test_device_flush.py``
(:139, :162, :176, :217), and its residency and fault tests: the budget
gate (:199: planes past ``gpu_hbm_budget_bytes`` take the host build),
a device fault mid-flush (:236: recorded on the breaker, the flush built
on the host, the next flush back on the device route) and a seeded run's
eviction round trip (:261: the flush's planes are resident without an
upload, evictable, and uploaded again from the host planes with the same
answers).
"""

import random

import jax
import numpy as np
import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from yugabyte_db_tpu_torch import workload
from test_torch_data import (JAX, MAX_HT, PORT, build_run, jax_rows,
                             make_schema, plain_planes)
from yugabyte_db_tpu.ops import flush as j_flush
from yugabyte_db_tpu.utils.metrics import flush_path_count
from yugabyte_db_tpu_torch.ops import flush as t_flush
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun, padded_blocks
from yugabyte_db_tpu_torch.storage import gpu_engine
from yugabyte_db_tpu_torch.storage.columnar import ColumnarRun
from yugabyte_db_tpu_torch.storage.residency import hbm_cache
from yugabyte_db_tpu_torch.utils import planes as P
from yugabyte_db_tpu_torch.utils.fault_injection import (arm_fault_once,
                                                         clear_faults)
from yugabyte_db_tpu_torch.utils.flags import FLAGS

R = 64


@pytest.fixture(scope="module", autouse=True)
def _plain_planes():
    with plain_planes():
        yield


def enc(schema, k, r):
    return schema.encode_primary_key(
        {"k": k, "r": r}, PORT.partition.compute_hash_code(schema, {"k": k}))


def sample_rows(schema, n=200, seed=11):
    """``tests/test_device_flush.py``'s ``sample_rows`` as the port's
    RowVersions: multi-version keys, tombstones, NULLs, TTLs, doubles,
    strings and same-(key, ht) write id ties."""
    RowVersion = PORT.row_version.RowVersion
    rnd = random.Random(seed)
    cids = {c.name: c.col_id for c in schema.value_columns}
    rows, ht = [], 0
    for i in range(n):
        ht += rnd.randrange(1, 3)
        key = enc(schema, rnd.choice(["p", "q", "rr"]), i % 41)
        roll = rnd.random()
        if roll < 0.1:
            rows.append(RowVersion(key, ht=ht, tombstone=True,
                                   write_id=i % 7))
        elif roll < 0.55:
            rows.append(RowVersion(
                key, ht=ht, liveness=True, write_id=i % 7,
                columns={cids["a"]: rnd.randrange(-1000, 1000),
                         cids["b"]: rnd.choice(["xy", "xyz-longer", None,
                                                "commonprefix-aa",
                                                "commonprefix-ab"]),
                         cids["c"]: rnd.uniform(-5, 5),
                         cids["d"]: rnd.randrange(-50, 50)},
                expire_ht=ht + 40 if rnd.random() < 0.2 else MAX_HT))
        else:
            col = rnd.choice(["a", "b", "c", "d"])
            val = {"a": rnd.randrange(-1000, 1000),
                   "b": rnd.choice(["w", None]),
                   "c": rnd.uniform(-5, 5),
                   "d": rnd.randrange(-50, 50)}[col]
            rows.append(RowVersion(key, ht=ht, write_id=i % 7,
                                   columns={cids[col]: val}))
    return rows, ht


def assert_runs_identical(a, b):
    """Byte-level equality of two ColumnarRuns (either package's)."""
    assert a.B == b.B and a.R == b.R
    for name in ("valid", "group_start", "tomb", "live", "ht_hi", "ht_lo",
                 "exp_hi", "exp_lo", "key_planes"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert set(a.cols) == set(b.cols)
    for cid, ca in a.cols.items():
        cb = b.cols[cid]
        for f in ("set_", "isnull", "cmp_planes"):
            assert np.array_equal(getattr(ca, f), getattr(cb, f)), (cid, f)
        assert (ca.arith is None) == (cb.arith is None)
        if ca.arith is not None:
            assert np.array_equal(ca.arith, cb.arith), cid
        if ca.varlen is not None:
            assert ca.varlen == cb.varlen, cid
    assert np.array_equal(a.row_keys, b.row_keys)
    assert [(m.min_key, m.max_key, m.num_valid) for m in a.blocks] == \
        [(m.min_key, m.max_key, m.num_valid) for m in b.blocks]
    for f in ("num_versions", "min_key", "max_key", "max_ht",
              "max_group_versions", "max_key_len", "varlen_max_len"):
        assert getattr(a, f) == getattr(b, f), f


def assert_trees_equal(got, want, path=""):
    """Two plane trees (torch or numpy leaves) equal in names, shapes,
    types and bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), path


def staged_inputs(schema, rows, R):
    """The JAX engine's replay inputs of ``rows`` (its ``_device_flush``
    staging, sort and packing), with its pad entries: (staged tree, perm,
    dst, gs, is_real) as numpy."""
    n = len(rows)
    m = 1 << max(10, (n - 1).bit_length())
    staged = ColumnarRun(schema, rows_per_block=m)
    staged.B = 1
    staged._alloc(1)
    staged._fill_block(0, [(r.key, [r]) for r in rows])
    wid = np.fromiter((r.write_id for r in rows), np.int64, n)
    sk = gpu_engine._flush_sortkey(staged.key_planes[0, :n],
                                   staged.ht_hi[0, :n], staged.ht_lo[0, :n],
                                   wid)
    perm = np.argsort(sk, kind="stable").astype(np.int32)
    kw_s = staged.key_planes[0][perm]
    gs = np.ones(n, bool)
    gs[1:] = (kw_s[1:] != kw_s[:-1]).any(axis=1)
    sizes = np.diff(np.append(np.flatnonzero(gs), n))
    ranges = ColumnarRun.pack_group_ranges(sizes.tolist(), R)
    B = len(ranges)
    Bp = padded_blocks(B, 8)
    rows_per = np.array([nr for _g, _n, nr in ranges], np.int64)
    offs = np.cumsum(rows_per) - rows_per
    dst = (np.repeat(np.arange(B), rows_per) * R + np.arange(n)
           - np.repeat(offs, rows_per)).astype(np.int32)
    pad = m - n
    perm = np.concatenate([perm, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.full(pad, Bp * R, np.int32)])
    gs = np.concatenate([gs, np.zeros(pad, bool)])
    tree = {k: getattr(staged, k)[0] for k in ("ht_hi", "ht_lo", "exp_hi",
                                               "exp_lo", "tomb", "live")}
    tree["cols"] = {}
    for cid, col in staged.cols.items():
        entry = {"set": col.set_[0], "isnull": col.isnull[0],
                 "cmp": col.cmp_planes[0]}
        if col.arith is not None:
            entry["arith"] = col.arith[0]
        tree["cols"][cid] = entry
    is_real = np.zeros(Bp, bool)
    is_real[:B] = True
    return tree, perm, dst, gs, is_real


@pytest.mark.parametrize("n,r", [(200, 64), (333, 16), (1500, 2048),
                                 (700, 100)])
def test_replay_flush_plain_equals_jax(n, r):
    ps = make_schema(PORT, "mixed")
    rows, _ = sample_rows(ps, n=n, seed=n)
    tree, perm, dst, gs, is_real = staged_inputs(ps, rows, r)
    ehi, elo = P.scalar_ht_planes(MAX_HT)
    want = jax.tree.map(np.asarray, jax.device_get(j_flush.replay_flush(
        tree, perm, dst, gs, is_real, ehi, elo, R=r)))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    ttree = {k: (t(v) if k != "cols" else
                 {cid: {kk: t(vv) for kk, vv in c.items()}
                  for cid, c in v.items()}) for k, v in tree.items()}
    got = t_flush.replay_flush(ttree, t(perm), t(dst), t(gs), t(is_real),
                               ehi, elo, r)
    assert_trees_equal(got, want)
    assert t_flush.replay_flush.launches == 0  # CPU: the plain version
    assert t_flush.flush_plane_nbytes(is_real.shape[0], r, ps) == \
        j_flush.flush_plane_nbytes(is_real.shape[0], r,
                                   make_schema(JAX, "mixed"))


def to_torch_tree(tree):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return {k: (t(v) if k != "cols" else
                {cid: {kk: t(vv) for kk, vv in c.items()}
                 for cid, c in v.items()}) for k, v in tree.items()}


# Drawn inputs (workload.replay_inputs): R, value columns, pad entries, a
# 2-word order column last, an odd block count.
DRAWN = [(100, 34, 30, True, False), (100, 3, 0, False, True),
         (8, 5, 17, False, False), (2048, 32, 9, True, False)]


@pytest.mark.parametrize("R,cols,pads,two,odd", DRAWN)
def test_replay_flush_plain_equals_jax_on_drawn_inputs(R, cols, pads, two,
                                                       odd):
    """K12's edge shapes (R = 100 with a 2-word order column in a chunk of
    32 and past it, a slot count that is not a multiple of 4, R = 8):
    the plain version equals the JAX ``replay_flush``."""
    staged, perm, dst, gs, is_real = workload.replay_inputs(
        333, R, cols, pads, seed=R + cols, two_word_last=two, odd_blocks=odd)
    want = jax.tree.map(np.asarray, jax.device_get(j_flush.replay_flush(
        staged, perm, dst, gs, is_real, 2**31 - 1, -1, R=R)))
    got = t_flush.replay_flush(
        to_torch_tree(staged), *(torch.from_numpy(a) for a in
                                 (perm, dst, gs, is_real)),
        2**31 - 1, -1, R)
    assert_trees_equal(got, want)


@pytest.mark.parametrize("widths,ariths", [
    ((), ()), ((1,), (True,)), ((2, 1, 2), (True, True, False)),
    ((2,) * 32, (True,) * 32), ((1, 2) * 16, (False, True) * 16)])
@pytest.mark.parametrize("top", [True, False])
def test_record_layout_covers_every_plane(widths, ariths, top):
    """K12's record: every plane of a staged row has its own words (the
    hybrid time and expiry only in the first chunk's), the flag bytes
    fit their words, and records are whole 16-byte units."""
    lay = t_flush.record_layout(widths, ariths, top)
    owner = {}

    def take(word, what):
        assert 0 <= word < lay["stride"] and word not in owner, (word, what)
        owner[word] = what

    for k in range(4 if top else 0):
        take(k, f"top {k}")
    n_flag_words = (2 + 2 * len(widths) + 3) // 4
    assert 4 * n_flag_words >= 2 + 2 * len(widths)
    for k in range(n_flag_words):
        take(lay["flags"] + k, "flags")
    for c, (w, a) in enumerate(zip(widths, ariths)):
        for q in range(w):
            take(lay["cmp"][c] + q, f"cmp {c}")
        assert (lay["arith"][c] >= 0) == a
        if a:
            take(lay["arith"][c], f"arith {c}")
    assert lay["stride"] % 4 == 0 and lay["stride"] - len(owner) < 4


def test_scratch_words_is_the_widest_chunk():
    """The scratch the calls of one flush share holds a record of the
    widest chunk's layout for each staged row."""
    staged, *_ = workload.replay_inputs(50, 64, 34, two_word_last=True)
    cols = list(staged["cols"].values())

    def stride(chunk, top):
        return t_flush.record_layout([c["cmp"].shape[1] for c in chunk],
                                     ["arith" in c for c in chunk],
                                     top)["stride"]

    want = 50 * max(stride(cols[:32], True), stride(cols[32:], False))
    assert t_flush.scratch_words(staged) == want
    one, *_ = workload.replay_inputs(7, 8, 0)
    assert t_flush.scratch_words(one) == 7 * stride([], True)


def test_device_flush_planes_identical_to_host_build():
    """The replayed run equals the host columnar build bit for bit (same
    sort, packing and padding), and the JAX ``tpu`` engine's device
    flush; its adopted device planes equal an upload of the host build."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    rows, _ = sample_rows(ps)
    eng = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    eng.apply(rows)
    eng.flush()
    assert eng.stats()["flush_paths"] == {"device": 1, "host": 0}
    assert eng.last_flush["route"] == "device"
    host = build_run(PORT, ps, rows, R)
    assert_runs_identical(eng.runs[0].crun, host)
    assert_trees_equal(eng.runs[0].dev.arrays,
                       DeviceRun(host, gpu_engine.PAD_BLOCKS,
                                 device="cpu").arrays)
    tpu = J.make_engine("tpu", js, {"rows_per_block": R})
    tpu.apply(jax_rows(rows))
    dev0 = flush_path_count("device")
    tpu.flush()
    assert flush_path_count("device") == dev0 + 1
    assert_runs_identical(eng.runs[0].crun, tpu.runs[0].crun)


def test_device_flush_scan_identity_vs_cpu_oracle():
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    rows, max_ht = sample_rows(ps, n=300, seed=7)
    cpu = J.make_engine("cpu", js, {})
    gpu = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    cpu.apply(jax_rows(rows))
    gpu.apply(rows)
    cpu.flush()
    gpu.flush()
    assert gpu.stats()["flush_paths"]["device"] == 1
    lo, hi = enc(ps, "p", 5), enc(ps, "p", 30)
    for kw in [dict(read_ht=rht) for rht in (MAX_HT, max_ht // 2,
                                             max_ht - 20, 1)] + \
            [dict(lower=lo, upper=hi, read_ht=MAX_HT)]:
        a = cpu.scan(J.ScanSpec(**kw))
        b = gpu.scan(T.ScanSpec(**kw))
        assert a.columns == b.columns and len(a.rows) == len(b.rows)
        for ra, rb in zip(a.rows, b.rows):
            for va, vb in zip(ra, rb):
                if isinstance(va, float):
                    assert vb == pytest.approx(va, rel=1e-4, abs=1e-4)
                else:
                    assert va == vb, kw


def test_write_id_tie_ordering():
    """Writes to one key at one hybrid time order by write id: the flush
    sort key breaks the tie so that the later write wins."""
    ps = make_schema(PORT, "mixed")
    RowVersion = PORT.row_version.RowVersion
    cids = {c.name: c.col_id for c in ps.value_columns}
    key = enc(ps, "p", 1)
    rows = [RowVersion(key, ht=10, liveness=True, write_id=0,
                       columns={cids["a"]: 1}),
            RowVersion(key, ht=10, write_id=1, columns={cids["a"]: 2}),
            RowVersion(key, ht=10, write_id=2, columns={cids["a"]: 3})]
    gpu = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    gpu.apply(rows)
    gpu.flush()
    assert gpu.stats()["flush_paths"]["device"] == 1
    assert_runs_identical(gpu.runs[0].crun, build_run(PORT, ps, rows, R))
    got = gpu.scan(T.ScanSpec(read_ht=MAX_HT, projection=["k", "r", "a"]))
    assert [r[-1] for r in got.rows] == [3]


def test_oversized_keys_take_the_host_route():
    ps = make_schema(PORT, "mixed")
    RowVersion = PORT.row_version.RowVersion
    cids = {c.name: c.col_id for c in ps.value_columns}
    rows = [RowVersion(enc(ps, "x" * 40 + str(i), i), ht=5 + i,
                       liveness=True, columns={cids["a"]: i})
            for i in range(8)]
    gpu = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    gpu.apply(rows)
    gpu.flush()
    assert gpu.stats()["flush_paths"] == {"device": 0, "host": 1}
    assert gpu.last_flush["route"] == "host"
    got = gpu.scan(T.ScanSpec(read_ht=MAX_HT, projection=["a"]))
    assert sorted(r[0] for r in got.rows) == list(range(8))


def test_key_group_longer_than_a_block_takes_the_host_route():
    """The packing refuses a key of more versions than a block holds: the
    device route steps aside and the host build refuses it as the JAX
    engine's does (compaction with a cutoff is the remedy)."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    RowVersion = PORT.row_version.RowVersion
    cids = {c.name: c.col_id for c in ps.value_columns}
    rows = [RowVersion(enc(ps, "p", 0), ht=i + 1, columns={cids["a"]: i})
            for i in range(10)]
    gpu = T.make_engine("gpu", ps, {"rows_per_block": 8, "device": "cpu"})
    tpu = J.make_engine("tpu", js, {"rows_per_block": 8})
    gpu.apply(rows)
    tpu.apply(jax_rows(rows))
    assert gpu._device_flush() is None
    with pytest.raises(ValueError, match="rows_per_block"):
        tpu.flush()
    with pytest.raises(ValueError, match="rows_per_block"):
        gpu.flush()


def test_rejected_value_takes_the_host_route():
    """A value the encoders reject leaves the device route to the host
    build, which rejects it as the JAX engine's does."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    RowVersion = PORT.row_version.RowVersion
    cids = {c.name: c.col_id for c in ps.value_columns}
    rows = [RowVersion(enc(ps, "p", 0), ht=1, columns={cids["a"]: "x"})]
    gpu = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    tpu = J.make_engine("tpu", js, {"rows_per_block": R})
    gpu.apply(rows)
    tpu.apply(jax_rows(rows))
    assert gpu._device_flush() is None
    with pytest.raises(ValueError) as want:
        tpu.flush()
    with pytest.raises(ValueError) as got:
        gpu.flush()
    assert str(got.value) == str(want.value)


def test_multi_version_and_flat_runs_after_device_flushes():
    """Several device flushes (flat and multi-version runs) then the
    delta overlay and a compaction over them: the JAX ``cpu`` engine's
    answers."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    rows, max_ht = sample_rows(ps, n=600, seed=5)
    cpu = J.make_engine("cpu", js, {})
    gpu = T.make_engine("gpu", ps, {"rows_per_block": 32, "device": "cpu"})
    for i in range(0, 600, 150):
        cpu.apply(jax_rows(rows[i:i + 150]))
        gpu.apply(rows[i:i + 150])
        gpu.flush()
    assert gpu.stats()["flush_paths"] == {"device": 4, "host": 0}
    spec = dict(read_ht=max_ht, aggregates=[("count", None), ("sum", "a"),
                                            ("max", "d")])

    def scan(eng, S):
        return eng.scan(S.ScanSpec(
            read_ht=spec["read_ht"],
            aggregates=[S.AggSpec(f, c) for f, c in spec["aggregates"]]))

    assert scan(gpu, T).rows == scan(cpu, J).rows
    gpu.compact(max_ht // 2)
    cpu.compact(max_ht // 2)
    assert scan(gpu, T).rows == scan(cpu, J).rows


@pytest.fixture
def budget_flag():
    """The port's budget flag restored, stray residents drained and armed
    faults cleared around a test."""
    old = FLAGS.get("gpu_hbm_budget_bytes")
    hbm_cache().evict_unpinned()
    yield lambda v: FLAGS.set("gpu_hbm_budget_bytes", int(v))
    FLAGS.set("gpu_hbm_budget_bytes", old)
    clear_faults()
    hbm_cache().evict_unpinned()


def assert_same_scan(cpu, gpu, kw):
    """The rows and resume key of ``gpu`` equal the JAX ``cpu`` engine's;
    ``kw``'s aggregates are (fn, column) pairs."""
    def spec(S):
        return S.ScanSpec(**dict(kw, aggregates=[
            S.AggSpec(*a) for a in kw.get("aggregates", [])]))

    a = cpu.scan(spec(J))
    b = gpu.scan(spec(T))
    assert a.columns == b.columns and len(a.rows) == len(b.rows)
    for ra, rb in zip(a.rows, b.rows):
        for va, vb in zip(ra, rb):
            if isinstance(va, float):
                assert vb == pytest.approx(va, rel=1e-4, abs=1e-4)
            else:
                assert va == vb, kw
    assert a.resume_key == b.resume_key


def engines(R=64):
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    return ps, J.make_engine("cpu", js, {}), T.make_engine(
        "gpu", ps, {"rows_per_block": R, "device": "cpu"})


def test_budget_gate_takes_the_host_route(budget_flag):
    """``tests/test_device_flush.py:199``: a flush whose padded planes
    exceed the budget takes the host build (seeding them would thrash the
    cache)."""
    budget_flag(1000)
    ps, cpu, gpu = engines()
    rows, _ = sample_rows(ps, n=100, seed=3)
    cpu.apply(jax_rows(rows))
    gpu.apply(rows)
    assert t_flush.flush_plane_nbytes(gpu_engine.PAD_BLOCKS, R, ps) > 1000
    cpu.flush()
    gpu.flush()
    assert gpu.stats()["flush_paths"] == {"device": 0, "host": 1}
    assert gpu.last_flush["route"] == "host"
    budget_flag(0)
    assert_same_scan(cpu, gpu, dict(read_ht=MAX_HT))
    assert gpu.stats()["host_reserves"] == 0
    gpu.close()


def test_dispatch_fault_takes_the_host_route_then_recovers(budget_flag):
    """``tests/test_device_flush.py:236``: a device fault mid-flush lands
    on the breaker and the flush is built on the host, with no row lost;
    the next flush (fault cleared, breaker closed) takes the device
    route."""
    ps, cpu, gpu = engines()
    cids = {c.name: c.col_id for c in ps.value_columns}
    rows1, _ = sample_rows(ps, n=60, seed=1)
    cpu.apply(jax_rows(rows1))
    gpu.apply(rows1)
    arm_fault_once("fault.gpu_dispatch")
    cpu.flush()
    gpu.flush()
    assert gpu.stats()["flush_paths"] == {"device": 0, "host": 1}
    assert gpu.breaker.consecutive_failures == 1
    assert gpu.breaker.state == "closed"  # threshold 3
    RowVersion = PORT.row_version.RowVersion
    rows2 = [RowVersion(enc(ps, "z", i), ht=10_000 + i, liveness=True,
                        columns={cids["a"]: i}) for i in range(20)]
    cpu.apply(jax_rows(rows2))
    gpu.apply(rows2)
    cpu.flush()
    gpu.flush()
    assert gpu.stats()["flush_paths"] == {"device": 1, "host": 1}
    assert gpu.breaker.consecutive_failures == 0
    assert_same_scan(cpu, gpu, dict(read_ht=MAX_HT))
    gpu.close()


def test_seeded_run_survives_eviction_roundtrip(budget_flag):
    """``tests/test_device_flush.py:261``: the device flush's planes are
    the run's resident payload with no upload, evictable like any upload,
    and the upload after the eviction (from the host planes read back
    from them) scans the same."""
    ps, cpu, gpu = engines()
    rows, _ = sample_rows(ps, n=150, seed=9)
    cpu.apply(jax_rows(rows))
    gpu.apply(rows)
    cpu.flush()
    gpu.flush()
    assert gpu.stats()["flush_paths"]["device"] == 1
    cache = hbm_cache()
    up0 = cache.stats()["demand_upload_bytes"]
    assert_same_scan(cpu, gpu, dict(read_ht=MAX_HT))
    assert cache.stats()["demand_upload_bytes"] == up0
    assert gpu.runs[0].peek_device() is not None
    assert cache.evict_unpinned() > 0
    assert gpu.runs[0].peek_device() is None
    assert_same_scan(cpu, gpu, dict(read_ht=MAX_HT))
    assert_same_scan(cpu, gpu, dict(read_ht=MAX_HT, aggregates=[
        ("count", None), ("sum", "a")]))
    assert cache.stats()["demand_upload_bytes"] > up0
    assert gpu.stats()["host_reserves"] == 0
    gpu.close()
