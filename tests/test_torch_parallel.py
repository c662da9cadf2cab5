"""The port's mesh scans (``parallel``) against the JAX package's.

The mirror of the JAX ``tests/test_parallel.py`` on the port's logical 4x2
mesh of the CPU (``DeviceMesh.logical``: one device in every cell, as the
JAX tests' 8 virtual CPU devices are one host), with the JAX world
builders re-made from a seed: each history is drawn once and built into
both packages' runs (MVCC histories with tombstones and partial rows,
TTLs, same-hybrid-time write ids; R = 16, window 2).

- Aggregates: every spec through the JAX ``sharded_aggregate`` on its 4x2
  CPU mesh and through the port's on the same runs: integers, counts,
  ``rows_scanned`` and extremes equal, floats within rel 1e-5 / abs 1e-3
  (the JAX test's ``check``); and each result against the JAX ``cpu``
  engine holding every tablet's rows. No FLOAT column is summed.
- Row pages: against the per-tablet JAX ``cpu`` engine scans concatenated
  in tablet order (the JAX tests' own oracle: the JAX mesh row page fails
  on this host, ROADMAP.md §3's caveats).
- The stack's maintenance: ``update_tablet`` in place (the per-device
  charge unchanged, the new run's answers, from the host run and from
  device planes), an encoded stack refusing it, an update waiting for a
  page in flight, and ``close()`` mid-serve.
- The service's fallbacks: runs the stack refuses fall back, a kernel's
  error raises.
"""

import copy
import gc
import random
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import yugabyte_db_tpu.models.datatypes as j_datatypes
import yugabyte_db_tpu.parallel as j_parallel
import yugabyte_db_tpu.storage as j_storage
import yugabyte_db_tpu_torch.models.datatypes as t_datatypes
import yugabyte_db_tpu_torch.storage as t_storage
from test_torch_data import JAX, PORT
from yugabyte_db_tpu_torch.ops import mesh as mesh_ops
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
from yugabyte_db_tpu_torch.parallel import (DeviceMesh, MeshSpecError,
                                            ShardedTablets, sharded_aggregate,
                                            sharded_row_page)
from yugabyte_db_tpu_torch.storage.residency import hbm_cache
from yugabyte_db_tpu_torch.utils.memtracker import root_tracker

R = 16
WINDOW = 2
COLUMNS = (("k", "STRING", "HASH"), ("r", "INT64", "RANGE"),
           ("a", "INT64", "REGULAR"), ("c", "DOUBLE", "REGULAR"),
           ("d", "INT32", "REGULAR"))


# -- the JAX test's worlds, drawn once and built on either side --------------

def make_schema(side):
    S = side.schema
    dt = j_datatypes if side is JAX else t_datatypes
    return S.Schema([S.ColumnSchema(n, getattr(dt.DataType, t),
                                    getattr(S.ColumnKind, k))
                     for n, t, k in COLUMNS], table_id="t")


def world_events(seed, num_tablets=4, num_keys=400):
    """``build_world``'s history: (tablet, (k, r), RowVersion keywords with
    columns by name) in apply order, and the largest hybrid time."""
    rng = random.Random(seed)
    ht, out = 100, []
    for i in range(num_keys):
        kr = (f"user{i:05d}", rng.randrange(10))
        t = i % num_tablets
        for _ in range(rng.randrange(1, 4)):
            ht += rng.randrange(1, 5)
            roll = rng.random()
            if roll < 0.08:
                out.append((t, kr, dict(ht=ht, tombstone=True)))
            elif roll < 0.2:
                out.append((t, kr, dict(ht=ht, columns={
                    "a": rng.randrange(-10**12, 10**12)})))
            else:
                out.append((t, kr, dict(ht=ht, liveness=True, columns={
                    "a": rng.randrange(-10**12, 10**12),
                    "c": rng.uniform(-1e6, 1e6),
                    "d": rng.randrange(-10**6, 10**6)})))
    return out, ht


def flat_events(seed, num_tablets=8, num_keys=800):
    """``build_flat_world``'s history: one version a key."""
    rng = random.Random(seed)
    ht, out = 100, []
    for i in range(num_keys):
        kr = (f"user{i:05d}", rng.randrange(10))
        t = i % num_tablets
        ht += 1
        if rng.random() < 0.05:
            out.append((t, kr, dict(ht=ht, tombstone=True)))
            continue
        cols = {"a": rng.randrange(-10**12, 10**12),
                "d": rng.randrange(-10**6, 10**6)}
        if rng.random() < 0.8:
            cols["c"] = rng.uniform(-1e6, 1e6)
        out.append((t, kr, dict(ht=ht, liveness=True, columns=cols)))
    return out, ht


def mvcc_events(seed, num_tablets=4, num_keys=240):
    """``build_mvcc_tablets``' history: tombstones, TTL expiry and
    same-hybrid-time write_id ties."""
    rng = random.Random(seed)
    ht, out = 100, []
    for i in range(num_keys):
        kr = (f"user{i:05d}", rng.randrange(10))
        t = i % num_tablets
        for _ in range(rng.randrange(1, 4)):
            ht += rng.randrange(1, 5)
            roll = rng.random()
            if roll < 0.08:
                out.append((t, kr, dict(ht=ht, tombstone=True)))
            elif roll < 0.16:
                out.append((t, kr, dict(ht=ht, liveness=True,
                                        expire_ht=ht + rng.randrange(1, 400),
                                        columns={"a": rng.randrange(10**9)})))
            elif roll < 0.24:
                out.append((t, kr, dict(ht=ht, liveness=True, columns={
                    "a": rng.randrange(10**9)})))
                out.append((t, kr, dict(ht=ht, write_id=1, columns={
                    "a": rng.randrange(10**9)})))
            elif roll < 0.4:
                out.append((t, kr, dict(ht=ht, columns={
                    "d": rng.randrange(-10**6, 10**6)})))
            else:
                out.append((t, kr, dict(ht=ht, liveness=True, columns={
                    "a": rng.randrange(-10**12, 10**12),
                    "c": rng.uniform(-1e6, 1e6),
                    "d": rng.randrange(-10**6, 10**6)})))
    return out, ht


def key_of(side, schema, kr):
    k, r = kr
    return schema.encode_primary_key(
        {"k": k, "r": r}, side.partition.compute_hash_code(schema, {"k": k}))


def build(side, events, num_tablets):
    """(schema, runs, versions a tablet) of ``events`` on ``side``."""
    schema = make_schema(side)
    cid = {c.name: c.col_id for c in schema.columns}
    mems = [side.memtable.MemTable() for _ in range(num_tablets)]
    per_tablet = [[] for _ in range(num_tablets)]
    for t, kr, kw in events:
        kw = dict(kw)
        if "columns" in kw:
            kw["columns"] = {cid[n]: v for n, v in kw["columns"].items()}
        rv = side.row_version.RowVersion(key_of(side, schema, kr), **kw)
        mems[t].apply([rv])
        per_tablet[t].append(rv)
    runs = [side.columnar.ColumnarRun.build(make_schema(side),
                                            m.drain_sorted(), R)
            for m in mems]
    return schema, runs, per_tablet


def jax_oracles(per_tablet):
    """(union engine, per-tablet engines): the JAX ``cpu`` engine."""
    schema = make_schema(JAX)
    union = j_storage.make_engine("cpu", schema)
    each = []
    for rows in per_tablet:
        o = j_storage.make_engine("cpu", schema)
        o.apply(rows)
        union.apply(rows)
        each.append(o)
    return union, each


def jax_mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("t", "b"))


def port_mesh():
    return DeviceMesh.logical(torch.device("cpu"), 4, 2)


class World:
    """One history built into both packages: JAX runs, port runs, the JAX
    oracles, the sorted keys (JAX bytes = port bytes) and the largest
    hybrid time."""

    def __init__(self, events, num_tablets):
        events, self.max_ht = events
        self.j_schema, self.j_runs, rows = build(JAX, events, num_tablets)
        self.t_schema, self.t_runs, _ = build(PORT, events, num_tablets)
        self.union, self.oracles = jax_oracles(rows)
        self.keys = sorted({key_of(JAX, self.j_schema, kr)
                            for _t, kr, _kw in events})
        assert self.keys == sorted({key_of(PORT, self.t_schema, kr)
                                    for _t, kr, _kw in events})

    def port_stack(self, **kw):
        return ShardedTablets(self.t_schema, self.t_runs, port_mesh(),
                              window_blocks=WINDOW, **kw)

    def tablet_rows(self, spec_kw, swap=None):
        """The per-tablet oracles' scans concatenated in tablet order (the
        JAX tests' row-page oracle); ``swap`` {t: engine} replaces one."""
        out = []
        for t, o in enumerate(self.oracles):
            o = (swap or {}).get(t, o)
            out.extend(o.scan(j_spec(spec_kw)).rows)
        return out


def j_spec(kw):
    kw = dict(kw)
    kw["aggregates"] = [j_storage.AggSpec(*a) for a in kw.get("aggregates",
                                                              [])]
    kw["predicates"] = [j_storage.Predicate(*p) for p in kw.get("predicates",
                                                                [])]
    return j_storage.ScanSpec(**kw)


def t_spec(kw):
    kw = dict(kw)
    kw["aggregates"] = [t_storage.AggSpec(*a) for a in kw.get("aggregates",
                                                              [])]
    kw["predicates"] = [t_storage.Predicate(*p) for p in kw.get("predicates",
                                                                [])]
    return t_storage.ScanSpec(**kw)


@pytest.fixture(scope="module")
def world():
    return World(world_events(7), 4)


@pytest.fixture(scope="module", params=["encoded", "plain"])
def stacks(request, world):
    """The JAX stack on its 4x2 CPU mesh and the port's on the logical
    4x2, both encoded (each package's default) or both plain."""
    encode = None if request.param == "encoded" else False
    j_st = j_parallel.ShardedTablets(world.j_schema, world.j_runs,
                                     jax_mesh(), window_blocks=WINDOW,
                                     encode=encode)
    t_st = world.port_stack(encode=encode)
    assert t_st.encoded == (request.param == "encoded") == j_st.encoded
    # One device holds every piece: its run is the JAX stack's flattened
    # block axis, encoded leaf for leaf as the JAX stack encodes it.
    assert t_st.enc_struct == j_st.enc_struct
    return j_st, t_st


AGGS = [("count", None), ("sum", "a"), ("min", "a"), ("max", "a"),
        ("sum", "d"), ("min", "d"), ("max", "c"), ("min", "c"), ("avg", "d"),
        ("count", "a")]


def same_value(g, w):
    if w is None or g is None:
        return g == w
    if isinstance(w, float):
        return g == pytest.approx(w, rel=1e-5, abs=1e-3)
    return g == w and type(g) is type(w)


def check(stacks, oracle, kw):
    """The port's aggregate against the JAX ``sharded_aggregate`` (every
    value, ``rows_scanned``) and the JAX ``cpu`` oracle."""
    j_st, t_st = stacks
    got = sharded_aggregate(t_st, t_spec(kw))
    want = j_parallel.sharded_aggregate(j_st, j_spec(kw))
    assert got.columns == want.columns
    assert got.rows_scanned == want.rows_scanned
    assert len(got.rows) == len(want.rows) == 1
    for g, w in zip(got.rows[0], want.rows[0]):
        assert same_value(g, w), (got.rows, want.rows)
    ref = oracle.scan(j_spec(kw))
    for g, w in zip(got.rows[0], ref.rows[0]):
        assert same_value(g, w), (got.rows, ref.rows)


def test_full_range_aggregates(world, stacks):
    check(stacks, world.union, dict(read_ht=world.max_ht + 1,
                                    aggregates=AGGS))


def test_bounded_range(world, stacks):
    keys = world.keys
    lo, hi = keys[len(keys) // 5], keys[4 * len(keys) // 5]
    check(stacks, world.union, dict(lower=lo, upper=hi,
                                    read_ht=world.max_ht + 1,
                                    aggregates=AGGS))


@pytest.mark.parametrize("at", ["150", "400", "800", "half"])
def test_historical_read_points(world, stacks, at):
    read_ht = world.max_ht // 2 if at == "half" else int(at)
    check(stacks, world.union, dict(read_ht=read_ht, aggregates=AGGS))


@pytest.mark.parametrize("preds", [
    [("a", ">=", 0)],
    [("d", "<", 0), ("a", "!=", 3)],
    [("c", ">", -5e5), ("c", "<=", 5e5)],
    [("a", ">", -10**11), ("d", ">=", -500000)],
], ids=["a", "d-a", "c-range", "a-d"])
def test_predicates(world, stacks, preds):
    check(stacks, world.union, dict(read_ht=world.max_ht + 1,
                                    predicates=preds, aggregates=AGGS))


def test_empty_range(world, stacks):
    check(stacks, world.union, dict(
        lower=world.keys[-1] + b"\xff", read_ht=world.max_ht + 1,
        aggregates=[("count", None), ("sum", "a"), ("min", "d")]))


def test_exact_int64_sum_at_scale():
    """Big magnitudes: the digit combine must be bit-exact where f64 would
    lose precision."""
    w = World(world_events(99, num_keys=300), 4)
    j_st = j_parallel.ShardedTablets(w.j_schema, w.j_runs, jax_mesh(),
                                     window_blocks=WINDOW)
    kw = dict(read_ht=w.max_ht + 1, aggregates=[("sum", "a")])
    got = sharded_aggregate(w.port_stack(), t_spec(kw))
    assert got.rows[0][0] == w.union.scan(j_spec(kw)).rows[0][0]
    assert got.rows[0][0] == j_parallel.sharded_aggregate(
        j_st, j_spec(kw)).rows[0][0]


@pytest.mark.parametrize("kw", [
    dict(aggregates=[("max", "k")]),
    dict(aggregates=[("count", None)], predicates=[("k", "=", "x")]),
    dict(aggregates=[("count", None)], group_by=["d"]),
    dict(projection=["k"]),
], ids=["key-agg", "key-pred", "group-by", "rows"])
def test_specs_the_mesh_refuses(world, kw):
    """The JAX module's refusals, as the port's own ``MeshSpecError`` (a
    ``ValueError``): the service falls back on them and on nothing
    else."""
    st = world.port_stack(encode=False)
    with pytest.raises(MeshSpecError):
        sharded_aggregate(st, t_spec(dict(read_ht=world.max_ht + 1, **kw)))
    with pytest.raises(MeshSpecError):
        sharded_row_page(st, t_spec(dict(read_ht=world.max_ht + 1,
                                         aggregates=[("count", None)])))
    assert issubclass(MeshSpecError, ValueError)


# -- sharded row/paging path -------------------------------------------------

def page_all(st, spec_kw, limit, max_pages=80):
    got, token, pages = [], None, 0
    while True:
        res = sharded_row_page(st, t_spec(dict(limit=limit, **spec_kw)),
                               resume=token)
        got.extend(res.rows)
        pages += 1
        assert pages < max_pages
        if res.resume_key is None:
            return got, pages
        token = res.resume_key


@pytest.mark.parametrize("encode", [False, True], ids=["plain", "encoded"])
def test_sharded_row_pages_ycsbe_style(encode):
    """8-way sharded YCSB-E shape on the logical mesh: LIMIT pages with a
    predicate, chained by resume token in tablet order, equal the
    per-tablet oracles' union exactly."""
    w = World(flat_events(3), 8)
    st = w.port_stack(encode=encode)
    spec_kw = dict(read_ht=w.max_ht + 1, predicates=[("d", ">=", 0)],
                   projection=["k", "r", "a", "d"])
    got, pages = page_all(st, spec_kw, 100, max_pages=50)
    assert got == w.tablet_rows(spec_kw)
    assert pages > 1


def test_sharded_row_pages_bounds_and_historical():
    w = World(flat_events(11, num_tablets=4, num_keys=300), 4)
    st = w.port_stack()
    lo = key_of(JAX, w.j_schema, ("user00050", 0))
    hi = key_of(JAX, w.j_schema, ("user00250", 0))
    for rht in (w.max_ht + 1, w.max_ht // 2 + 60):
        kw = dict(lower=lo, upper=hi, read_ht=rht, projection=["k", "a"])
        got = sharded_row_page(st, t_spec(dict(limit=4096, **kw)))
        assert sorted(got.rows) == sorted(w.tablet_rows(kw)), rht


@pytest.fixture(scope="module")
def mvcc_world():
    w = World(mvcc_events(17), 4)
    assert any(r.max_group_versions > 1 for r in w.t_runs)
    return w


@pytest.mark.parametrize("at", ["newest", "mid"])
def test_sharded_row_pages_mvcc(mvcc_world, at):
    """Row paging over MULTI-VERSION runs: the resolve in K7 (visibility,
    tombstone shadowing, TTL, write_id ties) equals the per-tablet
    oracles at the newest and a historical read point."""
    w = mvcc_world
    st = w.port_stack()
    assert not st.flat
    rht = w.max_ht + 1 if at == "newest" else w.max_ht // 2 + 60
    spec_kw = dict(read_ht=rht, projection=["k", "r", "a", "d"])
    got, pages = page_all(st, spec_kw, 64)
    assert got == w.tablet_rows(spec_kw)
    assert pages > 1


def test_sharded_aggregate_mvcc(mvcc_world):
    """The multi-version stack resolved at the read point, then K5 a
    device and the combine, against the JAX mesh program and the union
    oracle."""
    w = mvcc_world
    j_st = j_parallel.ShardedTablets(w.j_schema, w.j_runs, jax_mesh(),
                                     window_blocks=WINDOW)
    for rht in (w.max_ht + 1, w.max_ht // 2 + 60):
        check((j_st, w.port_stack()), w.union,
              dict(read_ht=rht, aggregates=AGGS))


def test_sharded_row_pages_encoded_vs_plain():
    """Encoded stacks serve pages identical to the plain stack's —
    including resume-token chains (a float column by setter index)."""
    w = World(mvcc_events(29), 4)
    st_enc = w.port_stack(encode=True)
    st_plain = w.port_stack(encode=False)
    assert st_enc.encoded and not st_plain.encoded
    assert st_enc.nbytes < st_plain.nbytes
    spec_kw = dict(read_ht=w.max_ht + 1, projection=["k", "r", "a", "c"])
    got_e, _ = page_all(st_enc, spec_kw, 96)
    got_p, _ = page_all(st_plain, spec_kw, 96)
    assert got_e == got_p
    assert got_e == w.tablet_rows(spec_kw)


def by_device():
    return {d: v["resident_bytes"]
            for d, v in hbm_cache().stats()["by_device"].items()}


def new_tablet(w, t):
    """(JAX oracle, port run, largest hybrid time) of tablet ``t``
    rewritten: every row's d the sentinel 777, a new."""
    old = w.oracles[t].scan(j_spec(dict(read_ht=w.max_ht + 1,
                                        projection=["k", "r"])))
    rng = random.Random(1)
    ht = w.max_ht
    events = []
    for k, r in old.rows:
        ht += 1
        events.append((0, (k, r), dict(ht=ht, liveness=True, columns={
            "a": rng.randrange(10**9), "d": 777})))
    _s, (run,), _rows = build(PORT, events, 1)
    _s, _j, (rows,) = build(JAX, events, 1)
    o = j_storage.make_engine("cpu", make_schema(JAX))
    o.apply(rows)
    return o, run, ht, len(old.rows)


@pytest.mark.parametrize("source", ["host", "device"])
def test_update_tablet_in_place(source):
    """Single-tablet refresh: update_tablet rewrites one slot of the
    stacked planes on the device with one ``stack_update`` launch (no
    rebuild), from the host run or from the run's device planes (an
    encoded upload, decoded by K10, its missing leaves from the host run);
    after it aggregates and row pages
    serve the NEW run's data, and the per-device charge is unchanged."""
    w = World(flat_events(41, num_tablets=4, num_keys=200), 4)
    st = w.port_stack(encode=False)
    before = by_device()
    t = 2
    o2, run, ht, n = new_tablet(w, t)
    dev = None
    if source == "device":
        dev = DeviceRun(run, 64, device="cpu", setting="auto").arrays
        # The encoded upload holds no arith plane of an integer column:
        # those leaves come from the host run.
        assert any("arith" not in c for c in dev["cols"].values())
    assert st.update_tablet(t, run, device_arrays=dev)
    assert by_device() == before
    spec_kw = dict(read_ht=ht + 1, projection=["k", "r", "a", "d"])
    got, _ = page_all(st, spec_kw, 4096)
    assert got == w.tablet_rows(spec_kw, swap={t: o2})
    res = sharded_row_page(st, t_spec(dict(
        read_ht=ht + 1, predicates=[("d", "=", 777)],
        projection=["k", "d"], limit=4096)))
    assert len(res.rows) == n
    agg = sharded_aggregate(st, t_spec(dict(
        read_ht=ht + 1, predicates=[("d", "=", 777)],
        aggregates=[("count", None), ("sum", "d")])))
    assert agg.rows == [(n, 777 * n)]
    # Encoded stacks can't splice a plain run in place: callers rebuild.
    st_enc = w.port_stack(encode=True)
    assert st_enc.encoded
    assert not st_enc.update_tablet(t, run)


def test_update_tablet_refuses_what_does_not_fit():
    w = World(flat_events(41, num_tablets=4, num_keys=200), 4)
    st = w.port_stack(encode=False)
    _o, run, _ht, _n = new_tablet(w, 1)
    assert not st.update_tablet(9, run)  # no such tablet
    big = build(PORT, flat_events(5, num_tablets=1, num_keys=2000)[0], 1)[1]
    assert not st.update_tablet(1, big[0])  # more blocks than the slot
    dev = DeviceRun(big[0], 64, device="cpu").arrays
    assert st._device_src(dev) is None
    launches = mesh_ops.stack_update.launches
    assert st.update_tablet(1, run)
    assert mesh_ops.stack_update.launches == launches  # CPU: no launch


def test_update_tablet_waits_for_a_page_in_flight(monkeypatch):
    """A page in flight reads one version of the stack: an update of a
    slot made while the page's gather is done but its host decode is not
    waits for the page, which answers the old run's rows; the next page
    answers the new run's."""
    from yugabyte_db_tpu_torch.parallel import sharded

    w = World(flat_events(41, num_tablets=4, num_keys=200), 4)
    st = w.port_stack(encode=False)
    t = 2
    o2, run, ht, _n = new_tablet(w, t)
    gathered, go = threading.Event(), threading.Event()
    gather = sharded.RG.gather_rows

    def paused(*args):
        out = gather(*args)
        gathered.set()
        assert go.wait(60)
        return out

    monkeypatch.setattr(sharded, "RG", SimpleNamespace(
        **{**vars(sharded.RG), "gather_rows": paused}))
    spec_kw = dict(read_ht=ht + 1, projection=["k", "r", "a", "d"])
    done: dict = {}
    reader = threading.Thread(target=lambda: done.setdefault(
        "page", sharded_row_page(st, t_spec(dict(limit=4096, **spec_kw)))))
    writer = threading.Thread(target=lambda: done.setdefault(
        "updated", st.update_tablet(t, run)))
    reader.start()
    assert gathered.wait(60)
    writer.start()
    try:
        writer.join(0.5)
        assert writer.is_alive()  # waiting for the page in flight
    finally:
        go.set()
        reader.join(60)
        writer.join(60)
    assert done["updated"]
    assert done["page"].rows == w.tablet_rows(spec_kw)
    monkeypatch.undo()
    got, _ = page_all(st, spec_kw, 4096)
    assert got == w.tablet_rows(spec_kw, swap={t: o2})


def service_peers(per_tablet, rows_per_block):
    """Peers as the service reads them: a port ``gpu`` engine on the CPU a
    tablet, each holding one flushed run."""
    schema = make_schema(PORT)
    peers = []
    for rows, rpb in zip(per_tablet, rows_per_block):
        eng = t_storage.make_engine("gpu", schema, {"rows_per_block": rpb,
                                                    "device": "cpu"})
        eng.apply(rows)
        eng.flush()
        peers.append(SimpleNamespace(tablet=SimpleNamespace(
            engine=eng, meta=SimpleNamespace(schema=schema))))
    return peers


def test_service_falls_back_only_for_refusals(monkeypatch):
    """``MeshScanService`` falls back for runs the stack refuses (the
    stack's own ``MeshSpecError``: rows a block that differ) and raises
    any other error of the stack's build or of a kernel, so that a
    device fault never reads as a fallback."""
    from yugabyte_db_tpu_torch import parallel
    from yugabyte_db_tpu_torch.parallel import sharded
    from yugabyte_db_tpu_torch.tserver.mesh_scan import MeshScanService

    events, max_ht = flat_events(43, num_tablets=2, num_keys=120)
    _s, _runs, per_tablet = build(PORT, events, 2)
    spec = t_spec(dict(read_ht=max_ht + 1, aggregates=[("count", None)]))
    want = sum(1 for _t, _kr, kw in events if not kw.get("tombstone"))
    svc = MeshScanService()
    other = copy.copy(_runs[1])
    other.R = R // 2
    with pytest.raises(MeshSpecError):
        ShardedTablets(make_schema(PORT), [_runs[0], other], port_mesh())
    assert svc.aggregate(service_peers(per_tablet, (R, 2 * R)),
                         spec) is None
    assert (svc.served, svc.fallbacks) == (0, 1)
    peers = service_peers(per_tablet, (R, R))
    assert svc.aggregate(peers, spec).rows == [(want,)]
    assert (svc.served, svc.fallbacks) == (1, 1)

    def fault(*_args):
        raise RuntimeError("full_agg kernel launch failed")

    monkeypatch.setattr(sharded, "full_agg", SimpleNamespace(
        **{**vars(sharded.full_agg), "full_aggregate": fault}))
    with pytest.raises(RuntimeError):
        svc.aggregate(peers, spec)
    monkeypatch.undo()

    def refused_device(*_args, **_kw):
        raise ValueError("full_aggregate runs on cuda or cpu, not meta")

    svc.drop_stacks()
    monkeypatch.setattr(parallel, "ShardedTablets", refused_device)
    with pytest.raises(ValueError):
        svc.aggregate(peers, spec)
    assert (svc.served, svc.fallbacks) == (1, 1)


def test_service_across_a_schema_change():
    """An ALTER reaches each tablet on its own: peers at two schema
    versions, or runs that do not yet hold an added column, fall back;
    once every run grew, the mesh serves the new column (NULL for the old
    rows), and after a DROP the dropped column's planes, which stay in
    the runs, are left out of the stack."""
    from yugabyte_db_tpu_torch.tserver.mesh_scan import MeshScanService

    events, max_ht = flat_events(47, num_tablets=2, num_keys=120)
    _s, _runs, per_tablet = build(PORT, events, 2)
    peers = service_peers(per_tablet, (R, R))
    live = sorted(key for _t, key, kw in events if not kw.get("tombstone"))
    count = t_spec(dict(read_ht=max_ht + 1, aggregates=[("count", None)]))
    svc = MeshScanService()
    assert svc.aggregate(peers, count).rows == [(len(live),)]
    added = make_schema(PORT).with_added_column("w",
                                                t_datatypes.DataType.INT64)
    peers[0].tablet.meta.schema = added
    assert svc.aggregate(peers, count) is None  # two versions
    peers[1].tablet.meta.schema = added
    assert svc.aggregate(peers, count) is None  # runs without w's planes
    assert (svc.served, svc.fallbacks) == (1, 2)
    for p in peers:
        p.tablet.engine.alter_schema(added)
    assert svc.aggregate(peers, count).rows == [(len(live),)]
    page = svc.rows(peers, t_spec(dict(read_ht=max_ht + 1,
                                       projection=["k", "r", "w"],
                                       limit=4096)))
    assert sorted(page.rows) == [(k, r, None) for k, r in live]
    dropped = added.with_dropped_column("d")
    for p in peers:
        p.tablet.meta.schema = dropped
        p.tablet.engine.alter_schema(dropped)
    assert svc.aggregate(peers, t_spec(dict(
        read_ht=max_ht + 1, aggregates=[("count", None), ("sum", "a")]))
    ).rows[0][0] == len(live)
    assert svc.rows(peers, t_spec(dict(read_ht=max_ht + 1,
                                       projection=["k", "d"]))) is None
    assert (svc.served, svc.served_rows, svc.fallbacks) == (3, 1, 3)


def test_stack_close_mid_serve():
    """close() releases the stack's residency pin immediately but keeps
    the planes alive for in-flight pages — the flush/compaction
    supersede-while-serving case must neither leak pins nor break the
    page being served."""
    tracker = root_tracker().child("device").child("sharded")
    gc.collect()
    hbm_cache().stats()  # reap stacks dead from earlier tests first
    base = tracker.consumption
    w = World(flat_events(43, num_tablets=4, num_keys=200), 4)
    st = w.port_stack()
    assert tracker.consumption - base == st.nbytes > 0
    assert by_device().get("cpu:0", 0) >= st.nbytes
    spec_kw = dict(read_ht=w.max_ht + 1, projection=["k", "a"])
    first = sharded_row_page(st, t_spec(dict(limit=32, **spec_kw)))
    assert first.resume_key is not None
    st.close()
    # Pin + MemTracker charge gone the moment the stack is superseded...
    assert tracker.consumption == base
    # ...and double-close stays a no-op.
    st.close()
    assert tracker.consumption == base
    # The in-flight page chain still serves, byte-identical.
    got = list(first.rows)
    token = first.resume_key
    while token is not None:
        res = sharded_row_page(st, t_spec(dict(limit=32, **spec_kw)),
                               resume=token)
        got.extend(res.rows)
        token = res.resume_key
    assert got == w.tablet_rows(spec_kw)


def test_per_device_charge_of_an_external_registration():
    """``add_external(..., dev_bytes=)`` charges each device its share in
    ``stats()["by_device"]`` and releases every share on invalidate (the
    JAX cache's per-device byte map)."""
    cache = hbm_cache()
    gc.collect()
    before = by_device()

    class Owner:
        pass

    owner = Owner()
    key = cache.add_external(owner, 0, None, "sharded_mesh",
                             dev_bytes={"cuda:0": 100, "cuda:1": 40})
    after = by_device()
    assert after.get("cuda:0", 0) - before.get("cuda:0", 0) == 100
    assert after.get("cuda:1", 0) - before.get("cuda:1", 0) == 40
    st = cache.stats()["by_device"]
    assert st["cuda:1"]["pinned_bytes"] >= 40
    cache.invalidate(key)
    assert {d: n for d, n in by_device().items() if n} == \
        {d: n for d, n in before.items() if n}
