"""The port's residency cache and the ``gpu`` engine under a budget,
against the JAX package's.

- ``HbmCache`` against the JAX ``HbmCache``: seeded scripts of
  register / acquire (with a priority) / pin / unpin / aux_put / aux_get
  / invalidate / owner death / evict_unpinned / add_external / peek,
  under several budgets, with numpy payloads of the same sizes; after
  every step both caches' ``stats()`` (hits, misses, evictions, resident,
  pinned, peak, demand-upload bytes, pools, encodings, devices) and the
  owners' trackers agree. The JAX cache counts hits, misses, evictions
  and uploads on process-wide counters, so its side is read as the
  change since the script's start.
- Mirrors of ``tests/test_residency.py`` on the ``gpu`` engine (CPU
  tensors), each with both packages' planes plain (``plain_planes``) and
  encoded ("auto": the side-car and the views are evicted with their run
  and rebuilt): :119 (a budget of 25% of the plane bytes; the rows of
  the JAX ``cpu`` and ``tpu`` engines), :146 (everything unpinned evicted
  at ``gpu_engine:plan:mem_snapshotted``), :166 (scan resistance), :206
  (accounting, the budget, detach on ``close()``) and :293 (the
  overlay's delta, here under a budget). Every engine test also asserts
  that no batch was re-served from the host and that the breaker stayed
  closed, and the first that no device tensor outlives its entry and
  that the cache releases the bytes of the allocations it held.

``tests/test_residency.py:251`` (``alter_schema`` and the cache's
``release``) is mirrored in ``tests/test_torch_engine_seam.py``. Not
mirrored: ``:366`` (the metrics registry and ``/memz``, ROADMAP.md §1 item
16).
"""

import gc
import random
import weakref

import numpy as np
import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.residency as j_res
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
import yugabyte_db_tpu_torch.storage.residency as t_res
from test_torch_data import (JAX, MAX_HT, PORT, jax_rows, make_schema,
                             plane_encoding)
from yugabyte_db_tpu.utils.flags import FLAGS as J_FLAGS
from yugabyte_db_tpu.utils.memtracker import root_tracker as j_root
from yugabyte_db_tpu_torch.storage.breaker import CLOSED
from yugabyte_db_tpu_torch.utils.flags import FLAGS as T_FLAGS
from yugabyte_db_tpu_torch.utils.memtracker import root_tracker as t_root
from yugabyte_db_tpu_torch.utils.sync_point import SYNC_POINT

J_BUDGET, T_BUDGET = "tpu_hbm_budget_bytes", "gpu_hbm_budget_bytes"


def set_budget(nbytes: int) -> None:
    """The budget on each side (each package reads its own flag)."""
    J_FLAGS.set(J_BUDGET, int(nbytes))
    T_FLAGS.set(T_BUDGET, int(nbytes))


@pytest.fixture
def budget_flag():
    """Restore both budget flags (and drain stray residents) around a
    test: the caches are process-wide and shared by a worker's tests."""
    gc.collect()  # dead engines of earlier tests release via weakrefs
    j_res.hbm_cache().evict_unpinned()
    t_res.hbm_cache().evict_unpinned()
    old = J_FLAGS.get(J_BUDGET), T_FLAGS.get(T_BUDGET)
    yield set_budget
    J_FLAGS.set(J_BUDGET, old[0])
    T_FLAGS.set(T_BUDGET, old[1])
    gc.collect()
    j_res.hbm_cache().evict_unpinned()
    t_res.hbm_cache().evict_unpinned()


# -- the cache against the JAX cache -----------------------------------------

COUNTERS = ("hits", "misses", "evictions", "demand_upload_bytes")


class _Owner:
    pass


class Side:
    """One package's cache, its tracker and the script's owners and
    keys (a key's index is the same on both sides)."""

    def __init__(self, res, root, name):
        self.res = res
        self.cache = res.HbmCache()
        self.tracker = root().child("device").child(name)
        self.owners: list = []
        self.keys: list = []
        self.base = {k: self.cache.stats()[k] for k in COUNTERS}

    def stats(self) -> dict:
        st = self.cache.stats()
        for k in COUNTERS:
            st[k] -= self.base[k]
        st["tracker"] = self.tracker.consumption
        return st


def script_step(rng: random.Random, n_keys: int) -> tuple:
    """One random operation of the script, as a tuple both sides replay."""
    op = rng.choices(["register", "acquire", "pin", "unpin", "aux_put",
                      "aux_get", "invalidate", "drop_owner",
                      "evict_unpinned", "external", "peek"],
                     weights=[3, 10, 3, 3, 3, 2, 2, 1, 1, 1, 1])[0]
    if op == "register" or not n_keys:
        return ("register",)
    k = rng.randrange(n_keys)
    if op in ("acquire", "pin"):
        return (op, k, rng.choice([None, "high", "low"]),
                rng.randrange(1, 400), rng.random() < 0.5)
    if op == "aux_put":
        return (op, k, rng.randrange(3), rng.randrange(1, 200))
    if op == "aux_get":
        return (op, k, rng.randrange(3))
    if op == "external":
        return (op, rng.randrange(1, 300))
    if op == "evict_unpinned":
        return (op,)
    return (op, k)


def replay(side: Side, step: tuple):
    """Apply one script step to one side; returns what it observed."""
    op, cache = step[0], side.cache
    if op == "register":
        o = _Owner()
        side.owners.append(o)
        side.keys.append(cache.register(o, side.tracker, "unit"))
        return None
    if op == "external":
        side.owners.append(None)
        side.keys.append(cache.add_external(None, step[1], side.tracker))
        return None
    if op == "evict_unpinned":
        return cache.evict_unpinned()
    key = side.keys[step[1]]
    if op in ("acquire", "pin"):
        _op, _k, priority, nbytes, hint = step
        payload = np.zeros(nbytes, np.uint8)
        got = getattr(cache, op)(key, lambda: (payload, nbytes),
                                 nbytes_hint=nbytes if hint else None,
                                 priority=priority)
        return int(getattr(got, "size", -1))  # -1: an external entry
    if op == "unpin":
        return cache.unpin(key)
    if op == "aux_put":
        return cache.aux_put(key, step[2], np.zeros(step[3], np.uint8),
                             step[3])
    if op == "aux_get":
        got = cache.aux_get(key, step[2])
        return None if got is None else int(got.size)
    if op == "peek":
        got = cache.peek(key)
        return None if got is None else int(getattr(got, "size", -1))
    if op == "drop_owner":
        side.owners[step[1]] = None
        gc.collect()
        return None
    return cache.invalidate(key)


@pytest.mark.parametrize("budget,seed", [(0, 1), (600, 2), (600, 3),
                                         (1500, 4), (250, 5), (4000, 6)])
def test_cache_matches_jax_step_for_step(budget, seed, budget_flag):
    """Both caches replay one seeded script and report the same
    observations and stats after every step."""
    budget_flag(budget)
    j = Side(j_res, j_root, f"torch_diff_j{seed}")
    t = Side(t_res, t_root, f"torch_diff_t{seed}")
    rng = random.Random(seed)
    try:
        for i in range(400):
            step = script_step(rng, len(j.keys))
            assert replay(t, step) == replay(j, step), (i, step)
            assert t.stats() == j.stats(), (i, step)
        assert t.stats()["evictions"] > 0 or budget == 0
    finally:
        j.tracker.detach()
        t.tracker.detach()


def test_device_nbytes_counts_each_allocation_once():
    """Views of one tensor count their storage once, and the storages of
    ``held`` trees are left out: what a tree adds to the allocator."""
    base = torch.zeros(64, dtype=torch.int32)
    other = torch.ones(10, dtype=torch.int64)
    tree = {"a": base, "b": base[8:16], "c": [base.view(8, 8), other]}
    assert t_res.device_nbytes(tree) == 64 * 4 + 10 * 8
    assert t_res.device_nbytes(tree, {"x": base[:1]}) == 10 * 8
    assert t_res.device_nbytes(tree, [other], base) == 0


def test_device_nbytes_matches_jax():
    """``device_nbytes`` of a nested tree (dicts, lists, tuples, None) of
    torch tensors equals the JAX function's over the same arrays."""
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 9, n).astype(dt) for n, dt in
              ((7, np.int32), (64, np.uint8), (5, np.int64), (3, bool))]
    tree = {"a": arrays[0], "cols": {1: [arrays[1], None],
                                     2: (arrays[2], {"bits": arrays[3]})}}

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(to_torch(v) for v in node)
        return None if node is None else torch.from_numpy(node)

    want = j_res.device_nbytes(tree)
    assert want == 7 * 4 + 64 + 5 * 8 + 3
    assert t_res.device_nbytes(to_torch(tree)) == want
    assert t_res.device_nbytes(tree) == want


def test_scan_resistance_protects_high_pool():
    """``tests/test_residency.py:166``: one full scan's worth of low-pri
    admissions does not evict the protected entries: the low pool drains
    first."""
    cache = t_res.HbmCache()
    tracker = t_root().child("device").child("torch_test_scanres")
    owners = []

    def entry(nbytes, priority):
        o = _Owner()
        owners.append(o)
        key = cache.register(o, tracker, "unit")
        cache.acquire(key, lambda: (("payload", nbytes), nbytes),
                      nbytes_hint=nbytes, priority=priority)
        return key

    old = T_FLAGS.get(T_BUDGET)
    try:
        T_FLAGS.set(T_BUDGET, 1000)
        hot = [entry(200, "high") for _ in range(3)]  # 600 B protected
        for _ in range(20):  # a "full scan" streaming low-pri entries
            entry(300, "low")
        for key in hot:
            def must_not_rebuild():
                raise AssertionError("a protected entry was evicted")
            assert cache.acquire(key, must_not_rebuild,
                                 priority="high") is not None
        assert cache.resident_bytes() <= 1000
    finally:
        T_FLAGS.set(T_BUDGET, old)
        owners.clear()
        gc.collect()
        tracker.detach()


# -- the engine under a budget -------------------------------------------------

def enc(schema, k, r):
    return schema.encode_primary_key(
        {"k": k, "r": r}, PORT.partition.compute_hash_code(schema, {"k": k}))


def load_engines(n_flushes=3, rows_per_flush=120, tail_writes=40):
    """``tests/test_residency.py``'s ``load_engines``: the JAX ``cpu`` and
    ``tpu`` engines and the port's ``gpu`` engine with several runs and
    live memtable writes."""
    ps, js = make_schema(PORT, "residency"), make_schema(JAX, "residency")
    e = {"cpu": J.make_engine("cpu", js, {}),
         "tpu": J.make_engine("tpu", js, {"rows_per_block": 32}),
         "gpu": T.make_engine("gpu", ps, {"rows_per_block": 32,
                                          "device": "cpu"})}
    RowVersion = PORT.row_version.RowVersion
    cids = {c.name: c.col_id for c in ps.value_columns}
    ht = 0
    for f in range(n_flushes):
        rows = []
        for i in range(rows_per_flush):
            ht += 1
            rows.append(RowVersion(
                enc(ps, ["p", "q", "rr"][i % 3], (f * 7 + i) % 211),
                ht=ht, liveness=True,
                columns={cids["a"]: i - 50, cids["b"]: f"v{f}-{i % 9}",
                         cids["c"]: i * 0.25 - 3.0}))
        apply(e, rows)
        for eng in e.values():
            eng.flush()
    rows = []
    for i in range(tail_writes):
        ht += 1
        rows.append(RowVersion(enc(ps, "q", i % 211), ht=ht, liveness=True,
                               columns={cids["a"]: 1000 + i}))
    apply(e, rows)
    return ps, e, ht


def apply(e, rows):
    for name, eng in e.items():
        eng.apply(rows if name == "gpu" else jax_rows(rows))


def plane_budget(gpu, fraction=0.25) -> int:
    total = sum(t._nbytes_hint() for t in gpu.runs)
    assert total > 0
    return max(int(total * fraction), 1)


def assert_same(e, **kw):
    """The rows of the ``gpu`` engine equal the JAX ``cpu`` engine's and
    the JAX ``tpu`` engine's (floats to ``test_engine_diff``'s
    tolerance)."""
    def spec(S):
        k = dict(kw)
        k["aggregates"] = [S.AggSpec(*a) for a in kw.get("aggregates", [])]
        k["predicates"] = [S.Predicate(*p) for p in kw.get("predicates", [])]
        return S.ScanSpec(**k)

    got = e["gpu"].scan(spec(T))
    for name in ("cpu", "tpu"):
        want = e[name].scan(spec(J))
        assert got.columns == want.columns, (name, kw)
        assert len(got.rows) == len(want.rows), (name, kw)
        for gr, wr in zip(got.rows, want.rows):
            for g, w in zip(gr, wr):
                if isinstance(w, float):
                    assert g == pytest.approx(w, rel=1e-4, abs=1e-4), kw
                else:
                    assert g == w, (name, kw)


def assert_no_reserve(gpu):
    st = gpu.stats()
    assert st["host_reserves"] == 0
    assert st["breaker"] == {"state": CLOSED, "trips": 0}


SCAN_BATTERY = [
    dict(read_ht=MAX_HT),
    dict(read_ht=MAX_HT, aggregates=[("count", None), ("sum", "a"),
                                     ("min", "a"), ("max", "a")]),
    dict(read_ht=MAX_HT, predicates=[("a", ">", 0)]),
]


def bounded(schema):
    return dict(read_ht=MAX_HT, lower=enc(schema, "p", 10),
                upper=enc(schema, "p", 150))


ENCODINGS = ["off", "auto"]


def close_all(e):
    for eng in e.values():
        eng.close()


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_engine_diff_under_tiny_budget(encoding, budget_flag):
    """``tests/test_residency.py:119``: a dataset four times the budget.
    Every answer equals the JAX engines' (misses upload from the host
    runs), residency settles to the budget once the pins are let go, and
    no device tensor outlives its entry: after ``evict_unpinned`` every
    payload, side-car and view tensor is freed."""
    with plane_encoding(encoding):
        schema, e, max_ht = load_engines()
        gpu = e["gpu"]
        budget = plane_budget(gpu, 0.25)
        budget_flag(budget)
        cache = t_res.hbm_cache()
        # The flushes seeded every run before the budget was set: start
        # cold, so that every run comes back through the budget.
        cache.evict_unpinned()
        try:
            miss0 = cache.stats()["misses"]
            for kw in SCAN_BATTERY:
                assert_same(e, **kw)
            assert_same(e, **bounded(schema))
            assert_same(e, read_ht=max_ht // 2)
            assert_same(e, read_ht=MAX_HT, lower=enc(schema, "q", 5),
                        upper=enc(schema, "q", 6),
                        aggregates=[("count", None)])
            gc.collect()
            cache.evict_unpinned()
            assert cache.resident_bytes() <= budget + cache.pinned_bytes()
            assert cache.stats()["misses"] > miss0
            # A compacted run (encoded under "auto": its side-car and its
            # view ride on its entry), resident while the budget is lifted:
            # once evicted, none of its device tensors is alive.
            for eng in e.values():
                eng.flush()
                eng.compact()
            budget_flag(0)
            assert_same(e, read_ht=MAX_HT, aggregates=[("count", None),
                                                       ("sum", "a")])
            assert_same(e, read_ht=max_ht // 2, aggregates=[
                ("count", None), ("min", "a")])
            assert_same(e, **bounded(schema))
            tensors = tensors_of(gpu)
            held = [weakref.ref(t) for t in tensors]
            assert held
            # What the cache releases is the bytes of the allocations it
            # held, each counted once (the smoke holds the card's
            # allocator to the same bytes).
            want = t_res.device_nbytes(tensors)
            del tensors
            gc.collect()
            res0 = cache.resident_bytes()
            cache.evict_unpinned()
            gc.collect()
            assert res0 - cache.resident_bytes() == want
            assert all(r() is None for r in held)
            assert_no_reserve(gpu)
        finally:
            close_all(e)


def tensors_of(gpu) -> list:
    """Every device tensor the cache holds for the engine's runs: each
    resident payload's planes and constant planes, and its aux values."""
    cache = t_res.hbm_cache()
    out = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            out.append(node)

    for t in gpu.runs:
        e = cache._entries.get(t._res_key)
        if e is None or e.payload is None:
            continue
        walk([e.payload.dev.arrays, e.payload.const])
        walk([v for v, _n in e.aux.values()])
    return out


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_engine_diff_mid_scan_eviction(encoding, budget_flag):
    """``tests/test_residency.py:146``: everything unpinned is evicted
    right after each spec's memtable snapshot; the plans take their runs
    again on demand and every answer is unchanged."""
    with plane_encoding(encoding):
        schema, e, _ = load_engines(n_flushes=2)
        budget_flag(plane_budget(e["gpu"], 0.25))
        cache = t_res.hbm_cache()
        ev0 = cache.stats()["evictions"]
        SYNC_POINT.set_callback("gpu_engine:plan:mem_snapshotted",
                                lambda _arg: cache.evict_unpinned())
        SYNC_POINT.enable()
        try:
            for kw in SCAN_BATTERY:
                assert_same(e, **kw)
            assert_same(e, **bounded(schema))
            assert cache.stats()["evictions"] > ev0
            assert_no_reserve(e["gpu"])
        finally:
            SYNC_POINT.disable_and_clear()
            close_all(e)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_accounting_budget_and_detach(encoding, budget_flag):
    """``tests/test_residency.py:206``: resident bytes equal the tracker
    subtree's, unpinned traffic never exceeds the budget at admission,
    and the engine's ``close()`` releases and detaches its device
    tracker."""
    cache = t_res.HbmCache()
    tracker = t_root().child("device").child("torch_test_acct")
    keep, observed = [], []
    SYNC_POINT.set_callback("hbm_cache:admit", lambda _arg: observed.append(
        cache.resident_bytes()))
    SYNC_POINT.enable()
    try:
        T_FLAGS.set(T_BUDGET, 512)
        for i in range(8):
            o = _Owner()
            keep.append(o)
            key = cache.register(o, tracker, f"e{i}")
            cache.acquire(key, lambda: (object(), 200), nbytes_hint=200)
        assert observed and max(observed) <= 512
        assert cache.resident_bytes() == tracker.consumption
        assert cache.stats()["evictions"] >= 6
    finally:
        SYNC_POINT.disable_and_clear()
        T_FLAGS.set(T_BUDGET, 0)
        keep.clear()
        gc.collect()
        tracker.detach()

    with plane_encoding(encoding):
        _schema, e, _ = load_engines(n_flushes=1, rows_per_flush=40,
                                     tail_writes=0)
        gpu = e["gpu"]
        gpu.scan(T.ScanSpec(read_ht=MAX_HT))
        assert gpu.device_tracker.consumption > 0
        assert gpu.device_tracker.consumption == sum(
            cache_entry_bytes(t) for t in gpu.runs)
        name = gpu.device_tracker.name
        parent = gpu.device_tracker.parent
        assert_no_reserve(gpu)
        close_all(e)
        assert gpu.device_tracker.consumption == 0
        assert name not in parent._children
        assert all(t._res_key not in t_res.hbm_cache()._entries
                   for t in gpu.runs)


def cache_entry_bytes(trun) -> int:
    e = t_res.hbm_cache()._entries.get(trun._res_key)
    return 0 if e is None else e.total_bytes


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_overlay_incremental_delta_under_budget(encoding, budget_flag):
    """``tests/test_residency.py:293`` under a budget of 25% of the plane
    bytes: the cached overlay advances by the memtable's delta (the same
    masked plane while only tracked keys change, a new one for new
    primary rows), its primary stays pinned and its masked plane charged
    while it is cached, and every answer equals the JAX engines'."""
    with plane_encoding(encoding):
        ps, js = make_schema(PORT, "residency"), make_schema(JAX, "residency")
        e = {"cpu": J.make_engine("cpu", js, {}),
             "tpu": J.make_engine("tpu", js, {"rows_per_block": 32}),
             "gpu": T.make_engine("gpu", ps, {"rows_per_block": 32,
                                              "device": "cpu"})}
        gpu = e["gpu"]
        RowVersion = PORT.row_version.RowVersion
        cids = {c.name: c.col_id for c in ps.value_columns}
        apply(e, [RowVersion(enc(ps, ["p", "q", "rr"][i % 3], i % 211),
                             ht=1 + i, liveness=True,
                             columns={cids["a"]: i - 50,
                                      cids["b"]: f"v{i % 9}",
                                      cids["c"]: i * 0.25 - 3.0})
                  for i in range(240)])
        for eng in e.values():
            eng.flush()
        apply(e, [RowVersion(enc(ps, "q", i), ht=500 + i, liveness=True,
                             columns={cids["a"]: 2_000 + i})
                  for i in range(24)])
        for eng in e.values():
            eng.flush()
        apply(e, [RowVersion(enc(ps, "q", i), ht=600 + i, liveness=True,
                             columns={cids["a"]: 3_000 + i})
                  for i in range(10)])
        budget_flag(plane_budget(gpu, 0.25))
        cache = t_res.hbm_cache()
        agg = dict(read_ht=MAX_HT, aggregates=[
            ("count", None), ("sum", "a"), ("min", "a"), ("max", "a")])
        try:
            assert_same(e, **agg)  # builds the overlay
            state1 = gpu._overlay_cache[3]
            assert state1 is not None
            primary = state1.masked.source
            assert gpu._overlay_pinned is primary
            ext = cache._entries[gpu._overlay_ext_key]
            assert ext.external and ext.nbytes == state1.masked.valid.numel()
            assert cache._entries[primary._res_key].pins >= 1

            def write(key_i, val, part="q"):
                apply(e, [RowVersion(enc(ps, part, key_i % 211),
                                     ht=10_000 + val, liveness=True,
                                     columns={cids["a"]: val})])

            for i in range(5):  # only keys the overlay already tracks
                write(i, 7_000 + i)
            cache.evict_unpinned()
            assert_same(e, **agg)
            state2 = gpu._overlay_cache[3]
            assert state2 is not state1
            assert state2.mem_count > state1.mem_count
            assert state2.masked is state1.masked
            assert len(state2.rows) == len(state1.rows)

            for i in range(30, 34):  # new keys present in the primary run
                write(i, 8_000 + i, part="p")
            assert_same(e, **agg)
            state3 = gpu._overlay_cache[3]
            assert len(state3.rows) > len(state2.rows)
            assert state3.keys == sorted(state3.keys)
            assert_same(e, **bounded(ps))
            assert_same(e, **agg)
            assert gpu._overlay_cache[3] is state3
            assert_no_reserve(gpu)
            # A flush drops the overlay: its pin and its masked plane go.
            gpu.flush()
            assert gpu._overlay_pinned is None
            assert gpu._overlay_ext_key is None
            assert cache._entries[primary._res_key].pins == 0
        finally:
            close_all(e)
