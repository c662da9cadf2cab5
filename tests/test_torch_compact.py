"""Compaction on the ``gpu`` engine against the JAX package's.

K11's plain version (``ops.compact.gc_mask_plain``) and its numpy twin
must give the JAX ``gc_mask`` / ``gc_mask_host`` bit for bit on seeded
sorted unions (tombstones, TTL expiries, spans of equal hybrid time, pad
rows; cutoffs at 0, mid-history and the newest hybrid time), and the
wrapper ``resident_gc_mask`` on CPU tensors the JAX ``resident_gc_mask``.
The engine's compaction (``tests/test_device_compact.py``'s shapes: a
random load over four runs, repeated compactions with TTLs, long keys that
take the host merge, the device mask route forced by setting
``HOST_GC_MASK_MAX`` to 0 in both packages) must give a merged run whose
host planes and entries equal the JAX ``tpu`` engine's byte for byte,
and scans at read points at or past the cutoff the answers of the JAX
``cpu`` and ``tpu`` engines. Also: the compaction trigger and the flush
at ``memtable_flush_versions``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine as TE
import yugabyte_db_tpu_torch.storage as T
from yugabyte_db_tpu_torch import workload
from test_torch_data import JAX, MAX_HT, PORT, jax_rows, plain_planes
from yugabyte_db_tpu.ops import compact as j_compact
from yugabyte_db_tpu_torch.ops import compact as t_compact
from yugabyte_db_tpu_torch.storage import cpu_engine as t_cpu_engine
from yugabyte_db_tpu_torch.storage import gpu_engine
from yugabyte_db_tpu_torch.storage.merge import merge_entry_streams
from yugabyte_db_tpu_torch.storage.residency import hbm_cache
from yugabyte_db_tpu_torch.utils import planes as P

# tests/test_device_compact.py's table.
DC_TABLE = [("k", "STRING", "HASH"), ("a", "INT64", "REGULAR"),
            ("b", "STRING", "REGULAR"), ("c", "DOUBLE", "REGULAR")]


@pytest.fixture(scope="module", autouse=True)
def _plain_planes():
    with plain_planes():
        yield


def dc_schema(side, table=DC_TABLE, table_id="dc"):
    S = side.schema
    return S.Schema([S.ColumnSchema(n, getattr(S.DataType, dt),
                                    getattr(S.ColumnKind, kind))
                     for n, dt, kind in table], table_id=table_id)


def encode(schema, name: str) -> bytes:
    return schema.encode_primary_key(
        {"k": name}, PORT.partition.compute_hash_code(schema, {"k": name}))


def random_load(schema, num_keys=300, writes=1200, seed=5, flushes=4):
    """(segments, max ht): ``tests/test_device_compact.py``'s
    ``_random_load`` as the port's RowVersions, cut where it flushes (the
    last segment is flushed too)."""
    RowVersion = PORT.row_version.RowVersion
    rng = random.Random(seed)
    cid = {c.name: c.col_id for c in schema.columns}
    ht = 10
    segments, cur = [], []
    for w in range(writes):
        key = encode(schema, f"u{rng.randrange(num_keys):04d}")
        ht += rng.randrange(1, 3)
        roll = rng.random()
        if roll < 0.08:
            rv = RowVersion(key, ht=ht, tombstone=True)
        elif roll < 0.16:
            rv = RowVersion(key, ht=ht, liveness=True,
                            columns={cid["a"]: rng.randrange(100)},
                            expire_ht=ht + rng.randrange(1, 50))
        else:
            cols = {}
            if rng.random() < 0.8:
                cols[cid["a"]] = rng.randrange(10**9)
            if rng.random() < 0.5:
                cols[cid["b"]] = rng.choice(["x", "yy", None])
            if rng.random() < 0.4:
                cols[cid["c"]] = rng.uniform(-5, 5)
            rv = RowVersion(key, ht=ht, liveness=rng.random() < 0.5,
                            columns=cols)
        cur.append(rv)
        if w and w % (writes // flushes) == 0:
            segments.append(cur)
            cur = []
    segments.append(cur)
    return segments, ht


def make_engines(segments, rows_per_block=64, schema_table=DC_TABLE):
    """The JAX ``cpu`` and ``tpu`` engines and the port's ``gpu`` engine
    (CPU device) after the same segments, each flushed."""
    js, ps = dc_schema(JAX, schema_table), dc_schema(PORT, schema_table)
    opts = {"rows_per_block": rows_per_block}
    e = {"cpu": J.make_engine("cpu", js, opts),
         "tpu": J.make_engine("tpu", js, opts),
         "gpu": T.make_engine("gpu", ps, dict(opts, device="cpu"))}
    for seg in segments:
        jseg = jax_rows(seg)
        for name in ("cpu", "tpu"):
            e[name].apply(jseg)
            e[name].flush()
        e["gpu"].apply(seg)
        e["gpu"].flush()
    return e


def signature(entries):
    return [(key, [(v.ht, v.tombstone, v.liveness,
                    tuple(sorted(v.columns.items())), v.expire_ht,
                    v.write_id) for v in versions])
            for key, versions in entries]


def port_entries(eng):
    return list(merge_entry_streams([t.crun.iter_entries()
                                     for t in eng.runs]))


def assert_runs_identical(a, b):
    """Two ColumnarRuns (either package's) equal plane for plane, in
    their host payloads and block bounds and every metadata field."""
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
        assert ca.varlen == cb.varlen, cid
    assert np.array_equal(a.row_keys, b.row_keys)
    assert [(m.min_key, m.max_key, m.num_valid) for m in a.blocks] == \
        [(m.min_key, m.max_key, m.num_valid) for m in b.blocks]
    for f in ("num_versions", "min_key", "max_key", "max_ht",
              "max_group_versions", "max_key_len", "varlen_max_len"):
        assert getattr(a, f) == getattr(b, f), f


def compact_all(e, cutoff):
    for name in ("cpu", "tpu", "gpu"):
        e[name].compact(cutoff)
    want = signature(e["cpu"].dump_entries())
    assert signature(e["tpu"].dump_entries()) == want
    assert signature(port_entries(e["gpu"])) == want
    if e["gpu"].runs:
        assert len(e["gpu"].runs) == len(e["tpu"].runs) == 1
        assert_runs_identical(e["gpu"].runs[0].crun, e["tpu"].runs[0].crun)


def same_scan(e, read_ht, **kw):
    """A full-table row scan at ``read_ht`` on the three engines: the JAX
    ``cpu`` engine's rows, the ``tpu`` engine's rows and rows_scanned."""
    want = e["cpu"].scan(J.ScanSpec(read_ht=read_ht, **kw))
    tpu = e["tpu"].scan(J.ScanSpec(read_ht=read_ht, **kw))
    got = e["gpu"].scan(T.ScanSpec(read_ht=read_ht, **kw))
    assert got.rows == want.rows == tpu.rows, read_ht
    assert got.resume_key == tpu.resume_key
    assert got.rows_scanned == tpu.rows_scanned


# -- K11's plain version and twin against the JAX functions --------------------

def sorted_union(seed: int, n_groups: int = 160, num_cols: int = 3,
                 pads: int = 24):
    """A sorted union (key groups, hybrid time descending inside each) as
    numpy planes: tombstones, liveness, TTL expiries, spans of equal
    hybrid time, unset columns, then ``pads`` pad rows in a group of their
    own (the JAX engine's padding: hybrid time and expiry 0, no flag).
    Returns (planes, max ht)."""
    rng = np.random.default_rng(seed)
    hts, exps, tomb, live, sets, new_group = [], [], [], [], [], []
    top = 0
    for _ in range(n_groups):
        n = int(rng.choice([1, 1, 2, 3, 5, 9, 40]))
        h = np.sort(rng.integers(1, 3000, n))[::-1]
        if n > 2 and rng.random() < 0.5:  # equal hybrid times side by side
            j = int(rng.integers(0, n - 1))
            h[j + 1] = h[j]
        top = max(top, int(h.max()))
        for i in range(n):
            hts.append(int(h[i]))
            tomb.append(rng.random() < 0.12)
            live.append(not tomb[-1] and rng.random() < 0.5)
            exps.append(int(h[i]) + int(rng.integers(1, 400))
                        if rng.random() < 0.15 else MAX_HT)
            sets.append([not tomb[-1] and rng.random() < 0.5
                         for _c in range(num_cols)])
            new_group.append(i == 0)
    ht_hi, ht_lo = P.ht_to_planes(np.array(hts, np.int64))
    exp_hi, exp_lo = P.ht_to_planes(np.array(exps, np.int64))
    zlo = np.int32(-(1 << 31))

    def padded(arr, fill):
        return np.concatenate([np.asarray(arr),
                               np.full(pads, fill, np.asarray(arr).dtype)])

    s = {"ht_hi": padded(ht_hi, 0), "ht_lo": padded(ht_lo, zlo),
         "exp_hi": padded(exp_hi, 0), "exp_lo": padded(exp_lo, zlo),
         "tomb": padded(np.array(tomb), False),
         "live": padded(np.array(live), False),
         "new_group": np.concatenate([np.array(new_group),
                                      np.arange(pads) == 0]),
         "set_": [padded(np.array([r[c] for r in sets]), False)
                  for c in range(num_cols)]}
    return s, top


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("where", ["zero", "mid", "newest"])
def test_gc_mask_plain_equals_jax_and_twins(seed, where):
    s, top = sorted_union(seed)
    cutoff = {"zero": 0, "mid": top // 2, "newest": top}[where]
    c_hi, c_lo = P.scalar_ht_planes(cutoff)
    cut = (c_hi, c_lo, c_hi, c_lo)
    num_cols = len(s["set_"])
    N = s["ht_hi"].shape[0]
    js = {k: jnp.asarray(np.stack(v) if k == "set_" else v)
          for k, v in s.items()}
    want = np.asarray(j_compact.compiled_gc_mask(num_cols, N)(
        js, tuple(jnp.int32(x) for x in cut)))
    ts = {k: torch.from_numpy(np.stack(v) if k == "set_" else v)
          for k, v in s.items()}
    got = t_compact.gc_mask_plain(num_cols, ts, cut).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(t_compact.gc_mask_host(num_cols, s, cut), want)
    assert np.array_equal(j_compact.gc_mask_host(num_cols, s, cut), want)
    if where == "mid":  # the union exercises every rule
        assert not want.all() and want.any()


def test_resident_gc_mask_on_the_cpu_equals_jax():
    """The wrapper on CPU tensors gathers each union row through ``idx``
    from several runs' [B, R] planes (pad rows at -1) as the JAX
    ``resident_gc_mask`` does."""
    rng = np.random.default_rng(7)
    s, top = sorted_union(3, pads=0)
    N = s["ht_hi"].shape[0]
    num_cols = len(s["set_"])
    # Scatter the union's rows over three runs of [B, R] planes.
    R, sizes = 16, (40, 24, 56)
    runs = []
    for B in sizes:
        runs.append({k: np.zeros((B, R), np.int32)
                     for k in ("ht_hi", "ht_lo", "exp_hi", "exp_lo")})
        runs[-1].update(tomb=np.zeros((B, R), bool),
                        live=np.zeros((B, R), bool))
        runs[-1]["sets"] = [np.zeros((B, R), bool) for _ in range(num_cols)]
    total = sum(sizes) * R
    slots = rng.choice(total, size=N, replace=False)
    offsets = np.cumsum([0] + [B * R for B in sizes])
    for i, f in enumerate(slots):
        r = int(np.searchsorted(offsets, f, side="right") - 1)
        b, row = divmod(int(f - offsets[r]), R)
        for k in ("ht_hi", "ht_lo", "exp_hi", "exp_lo", "tomb", "live"):
            runs[r][k][b, row] = s[k][i]
        for c in range(num_cols):
            runs[r]["sets"][c][b, row] = s["set_"][c][i]
    pads = 20
    idx = np.concatenate([slots, np.full(pads, -1)]).astype(np.int32)
    new_group = np.concatenate([s["new_group"], np.arange(pads) == 0])
    c_hi, c_lo = P.scalar_ht_planes(top // 2)
    cut = (c_hi, c_lo, c_hi, c_lo)
    want = np.asarray(j_compact.resident_gc_mask(
        tuple({k: (tuple(jnp.asarray(x) for x in v) if k == "sets"
                   else jnp.asarray(v)) for k, v in r.items()}
              for r in runs),
        jnp.asarray(idx), jnp.asarray(new_group),
        tuple(jnp.int32(x) for x in cut)))
    got = t_compact.resident_gc_mask(
        tuple({k: (tuple(torch.from_numpy(x) for x in v) if k == "sets"
                   else torch.from_numpy(v)) for k, v in r.items()}
              for r in runs),
        torch.from_numpy(idx), torch.from_numpy(new_group),
        torch.from_numpy(np.flatnonzero(new_group).astype(np.int32)), cut)
    assert np.array_equal(got.numpy(), want)
    assert t_compact.resident_gc_mask.launches == 0  # CPU: no kernel


# -- K11's edge shapes: a key group of ~5,000 versions, 40 columns ---------------

LONG = 5000


@pytest.fixture(scope="module")
def long_union():
    """``workload.gc_union``: 200 groups, 40 columns, a group of LONG
    versions in spans of 70 equal hybrid times, 24 pad rows."""
    return workload.gc_union(200, 40, ((50, LONG),), pads=24, seed=21)


@pytest.mark.parametrize("where", ["zero", "mid", "newest"])
def test_gc_mask_on_a_long_group_equals_jax_and_twins(long_union, where):
    s, top = long_union
    cutoff = {"zero": 0, "mid": top // 2, "newest": top}[where]
    c_hi, c_lo = P.scalar_ht_planes(cutoff)
    cut = (c_hi, c_lo, c_hi, c_lo)
    N = s["ht_hi"].shape[0]
    js = {k: jnp.asarray(np.stack(v) if k == "set_" else v)
          for k, v in s.items()}
    want = np.asarray(j_compact.compiled_gc_mask(40, N)(
        js, tuple(jnp.int32(x) for x in cut)))
    ts = {k: torch.from_numpy(np.stack(v) if k == "set_" else v)
          for k, v in s.items()}
    assert np.array_equal(t_compact.gc_mask_plain(40, ts, cut).numpy(), want)
    assert np.array_equal(t_compact.gc_mask_host(40, s, cut), want)
    assert np.array_equal(j_compact.gc_mask_host(40, s, cut), want)
    if where == "mid":
        assert not want.all() and want.any()


def test_resident_gc_mask_on_a_long_group_equals_jax(long_union):
    """The long union spread over 4 runs' [B, 64] planes
    (``workload.scatter_union``): the wrapper on CPU tensors equals the
    JAX ``resident_gc_mask``."""
    s, top = long_union
    runs, idx = workload.scatter_union(s, 4, 64, pads=24)
    c_hi, c_lo = P.scalar_ht_planes(top // 2)
    cut = (c_hi, c_lo, c_hi, c_lo)
    want = np.asarray(j_compact.resident_gc_mask(
        tuple({k: (tuple(jnp.asarray(x) for x in v) if k == "sets"
                   else jnp.asarray(v)) for k, v in r.items()}
              for r in runs),
        jnp.asarray(idx), jnp.asarray(s["new_group"]),
        tuple(jnp.int32(x) for x in cut)))
    got = t_compact.resident_gc_mask(
        tuple({k: (tuple(torch.from_numpy(x) for x in v) if k == "sets"
                   else torch.from_numpy(v)) for k, v in r.items()}
              for r in runs),
        torch.from_numpy(idx), torch.from_numpy(s["new_group"]),
        torch.from_numpy(np.flatnonzero(s["new_group"]).astype(np.int32)),
        cut)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), t_compact.gc_mask_host(40, s, cut))


@pytest.mark.parametrize("num_cols", [3, 40, 256])
def test_tile_plan_owns_every_group_once(long_union, num_cols):
    """K11's blocks: every key group is owned by exactly one tile, the
    one holding its first row, and a block stages its groups' rows from
    the first, at most ``tile_rows(...)[1]`` of them."""
    tile, cap = t_compact.tile_rows(num_cols)
    assert cap >= tile
    for starts, N in ((np.flatnonzero(long_union[0]["new_group"]),
                       long_union[0]["new_group"].shape[0]),
                      (np.arange(0, 10_000, 3), 10_001),
                      (np.array([0]), 3 * tile + 5)):
        plan = t_compact.tile_plan(starts, N, num_cols)
        assert len(plan) == -(-N // tile)
        owned = []
        for b, (ga, gb, lo, staged) in enumerate(plan):
            owned += range(ga, gb)
            if ga == gb:
                continue
            assert b * tile <= starts[ga] and starts[gb - 1] < (b + 1) * tile
            end = starts[gb] if gb < starts.size else N
            assert lo == starts[ga] and staged == min(cap, end - lo)
        assert owned == list(range(starts.size))


def test_shared_bytes_fit_a_block():
    """K11's shared memory stays under a block's 227 KB at 256 columns
    (two blocks an SM) and lets 4 blocks share an SM at 3 columns."""
    assert 2 * t_compact.shared_bytes(256, 64) <= 232_448
    assert 4 * t_compact.shared_bytes(3, 4) <= 232_448
    assert t_compact.shared_bytes(3, 65) < t_compact.shared_bytes(3, 64)


# -- the engine ----------------------------------------------------------------

@pytest.mark.parametrize("cutoff_frac", [0.0, 0.5, 1.0])
def test_compact_identical(cutoff_frac):
    segments, ht = random_load(dc_schema(PORT))
    e = make_engines(segments)
    assert len(e["gpu"].runs) == 4
    assert e["gpu"].stats()["flush_paths"] == {"device": 4, "host": 0}
    cutoff = int(ht * cutoff_frac)
    compact_all(e, cutoff)
    assert e["gpu"].stats()["compact_paths"] == {"k11": 0, "twin": 1,
                                                 "host": 0}
    for read_ht in (cutoff or 1, ht // 2 + cutoff // 2, ht + 1):
        if read_ht >= cutoff:
            same_scan(e, read_ht)


def test_compact_repeated_and_ttl():
    schema = dc_schema(PORT)
    segments, ht = random_load(schema, num_keys=80, writes=600, seed=9)
    e = make_engines(segments, rows_per_block=32)
    for cutoff in (ht // 4, ht // 2, ht):
        compact_all(e, cutoff)
    same_scan(e, ht + 1)


def test_long_keys_take_the_host_merge():
    RowVersion = PORT.row_version.RowVersion
    ps = dc_schema(PORT)
    cid = {c.name: c.col_id for c in ps.columns}
    segments, cur = [], []
    for i in range(40):
        key = encode(ps, f"very-long-key-{'x' * 40}-{i:03d}")
        cur.append(RowVersion(key, ht=i + 1, liveness=True,
                              columns={cid["a"]: i}))
        if i % 13 == 12:
            segments.append(cur)
            cur = []
    segments.append(cur)
    e = make_engines(segments)
    # Keys past the prefix planes take the host build at flush too.
    assert e["gpu"].stats()["flush_paths"]["host"] == len(segments)
    compact_all(e, 40)
    assert e["gpu"].stats()["compact_paths"] == {"k11": 0, "twin": 0,
                                                 "host": 1}
    same_scan(e, 41)


def test_device_mask_route(monkeypatch):
    """The retention mask of the large-union route (K11's wrapper; on the
    CPU its plain version over the gathered resident planes), forced in
    both packages."""
    monkeypatch.setattr(TE, "HOST_GC_MASK_MAX", 0)
    monkeypatch.setattr(gpu_engine, "HOST_GC_MASK_MAX", 0)
    segments, ht = random_load(dc_schema(PORT), seed=23)
    e = make_engines(segments)
    compact_all(e, ht // 2)
    assert e["gpu"].stats()["compact_paths"] == {"k11": 1, "twin": 0,
                                                 "host": 0}
    assert e["gpu"].last_compact["route"] == "k11"
    same_scan(e, ht + 1)


def test_compaction_drops_what_pointed_at_the_old_runs():
    segments, ht = random_load(dc_schema(PORT), num_keys=60, writes=400,
                               seed=4)
    e = make_engines(segments[:-1])
    e["gpu"].apply(segments[-1])  # a live memtable beside the runs
    old = list(e["gpu"].runs)
    agg = T.ScanSpec(read_ht=ht + 1, aggregates=[T.AggSpec("count", None),
                                                 T.AggSpec("sum", "a")])
    e["gpu"].scan(agg)  # builds the overlay
    assert e["gpu"]._overlay_cache is not None
    e["gpu"].compact(ht)
    assert e["gpu"]._overlay_cache is None and not e["gpu"]._plan_cache
    # The old runs' residency entries are gone, and so is the overlay's
    # pin on its primary.
    assert all(t.peek_device() is None and
               t._res_key not in hbm_cache()._entries for t in old)
    assert e["gpu"]._overlay_pinned is None
    assert e["gpu"].memtable.num_versions == len(segments[-1])
    for name in ("cpu", "tpu"):
        e[name].apply(jax_rows(segments[-1]))
        e[name].compact(ht)
    want = e["cpu"].scan(J.ScanSpec(
        read_ht=ht + 1, aggregates=[J.AggSpec("count", None),
                                    J.AggSpec("sum", "a")]))
    assert e["gpu"].scan(agg).rows == want.rows


# -- reads after compaction ------------------------------------------------------

READS_TABLE = [("k", "STRING", "HASH"), ("r", "INT64", "RANGE"),
               ("a", "INT64", "REGULAR"), ("c", "DOUBLE", "REGULAR"),
               ("d", "INT32", "REGULAR")]


@pytest.fixture(scope="module")
def compacted():
    """The bench table's three engines after a multi-version history over
    four flushes and a compaction at its mid point."""
    from test_torch_data import multiversion_rows

    ps = dc_schema(PORT, READS_TABLE)
    rows, ht = multiversion_rows(PORT, ps, n=1600, nkeys=300, seed=11)
    q = len(rows) // 4
    segments = [rows[i * q:(i + 1) * q] for i in range(3)] + [rows[3 * q:]]
    e = make_engines(segments, schema_table=READS_TABLE)
    cutoff = ht // 2
    compact_all(e, cutoff)
    e["ht"], e["cutoff"] = ht, cutoff
    return e


AGGS = [[("count", None), ("sum", "a"), ("min", "d"), ("max", "a")],
        [("count", "d"), ("sum", "d"), ("avg", "a")],
        [("sum", "c"), ("min", "c"), ("max", "c")]]


@pytest.mark.parametrize("which", range(len(AGGS)))
def test_aggregates_after_compaction(compacted, which):
    e = compacted
    for read_ht in (e["cutoff"], (e["cutoff"] + e["ht"]) // 2, e["ht"] + 1):
        for preds in ([], [("d", ">=", 0)]):
            kw = dict(read_ht=read_ht)
            want = e["cpu"].scan(J.ScanSpec(
                aggregates=[J.AggSpec(f, c) for f, c in AGGS[which]],
                predicates=[J.Predicate(*p) for p in preds], **kw))
            got = e["gpu"].scan(T.ScanSpec(
                aggregates=[T.AggSpec(f, c) for f, c in AGGS[which]],
                predicates=[T.Predicate(*p) for p in preds], **kw))
            assert got.columns == want.columns
            for g, w in zip(got.rows[0], want.rows[0]):
                if isinstance(w, float):
                    assert g == pytest.approx(w, rel=1e-4, abs=1e-4)
                else:
                    assert g == w, (read_ht, preds)


def test_group_by_after_compaction(compacted):
    e = compacted
    for read_ht in (e["cutoff"], e["ht"] + 1):
        kw = dict(read_ht=read_ht, group_by=["d"])
        want = e["cpu"].scan(J.ScanSpec(
            aggregates=[J.AggSpec("count", None), J.AggSpec("sum", "a")],
            predicates=[J.Predicate("d", "<", 0)], **kw))
        got = e["gpu"].scan(T.ScanSpec(
            aggregates=[T.AggSpec("count", None), T.AggSpec("sum", "a")],
            predicates=[T.Predicate("d", "<", 0)], **kw))
        assert got.rows == want.rows


def test_limit_pages_after_compaction(compacted):
    e = compacted
    for read_ht in (e["cutoff"], e["ht"] + 1):
        lower, pages = b"", 0
        while True:
            kw = dict(read_ht=read_ht, lower=lower, limit=37,
                      projection=["k", "r", "a", "d"])
            want = e["cpu"].scan(J.ScanSpec(**kw))
            tpu = e["tpu"].scan(J.ScanSpec(**kw))
            got = e["gpu"].scan(T.ScanSpec(**kw))
            assert got.rows == want.rows == tpu.rows
            assert got.resume_key == want.resume_key == tpu.resume_key
            assert got.rows_scanned == tpu.rows_scanned
            pages += 1
            if got.resume_key is None:
                break
            lower = got.resume_key
        assert pages > 3


# -- the triggers ----------------------------------------------------------------

def test_maybe_compact_fires_at_the_trigger():
    ps = dc_schema(PORT)
    segments, ht = random_load(ps, num_keys=50, writes=400, seed=2,
                               flushes=4)
    eng = T.make_engine("gpu", ps, {"rows_per_block": 32, "device": "cpu",
                                    "compaction_trigger": 3})
    fired = []
    for seg in segments:
        eng.apply(seg)
        eng.flush()
        fired.append(eng.maybe_compact())
    assert fired == [False, False, True, False]
    assert eng.stats()["num_runs"] == 2
    default = T.make_engine("gpu", ps, {"device": "cpu"})
    for seg in segments[:3]:
        default.apply(seg)
        default.flush()
    assert not default.maybe_compact()  # the default trigger is 4 runs
    default.apply(segments[3])
    default.flush()
    assert default.maybe_compact() and default.stats()["num_runs"] == 1


def test_apply_flushes_at_memtable_flush_versions():
    ps = dc_schema(PORT)
    segments, ht = random_load(ps, num_keys=50, writes=400, seed=3)
    rows = [r for seg in segments for r in seg]
    eng = T.make_engine("gpu", ps, {"rows_per_block": 32, "device": "cpu",
                                    "memtable_flush_versions": 90,
                                    "compaction_trigger": 3})
    ref = J.make_engine("cpu", dc_schema(JAX))
    ref.apply(jax_rows(rows))
    for i in range(0, len(rows), 30):
        eng.apply(rows[i:i + 30])
        assert eng.memtable.num_versions < 90
    # 400 versions in batches of 30: a flush at every third batch (90),
    # and a compaction at every third run.
    assert eng.stats()["flush_paths"]["device"] == 4
    assert eng.stats()["compact_paths"]["twin"] == 1
    assert eng.stats()["num_runs"] == 2
    assert eng.scan(T.ScanSpec(read_ht=ht + 1)).rows == \
        ref.scan(J.ScanSpec(read_ht=ht + 1)).rows


def test_gc_versions_is_the_reference_rule():
    """The port's ``gc_versions`` keeps what the JAX ``cpu`` engine's
    ``_gc_versions`` keeps, key by key."""
    from yugabyte_db_tpu.storage.cpu_engine import CpuStorageEngine

    ps = dc_schema(PORT)
    segments, ht = random_load(ps, num_keys=40, writes=500, seed=8)
    rows = [r for seg in segments for r in seg]
    by_key: dict = {}
    for r in rows:
        by_key.setdefault(r.key, []).append(r)
    for cutoff in (0, ht // 3, ht):
        for key, versions in by_key.items():
            versions = sorted(versions, key=lambda v: (-v.ht, -v.write_id))
            got = t_cpu_engine.gc_versions(key, versions, cutoff)
            want = CpuStorageEngine._gc_versions(key, jax_rows(versions),
                                                 cutoff)
            assert signature([(key, got)]) == signature([(key, want)])
