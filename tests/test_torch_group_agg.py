"""K8 (``ops.group_agg``) and the ``gpu`` engine's grouped route against
the JAX package.

- The plain version against the JAX program ``compiled_grouped`` on the
  CPU backend, on the same planes (the JAX engine's run uploaded to the
  port), bucket by bucket: count, rep, key minima and maxima, scanned,
  negs, each COUNT and n exactly, and each sum decoded to a Python int
  (where no negative input voids the JAX program's digit sums). On a
  flat run, and on a multi-version run through ``resolve_view_plain``.
- The engine (``device="cpu"``) against the JAX ``tpu`` and ``cpu``
  engines on every case of ``tests/test_group_agg.py`` and a few more:
  the same columns and rows exactly, and the ``tpu`` engine's
  ``rows_scanned``.
- The specs K8 does not take (served by the gather or the row scan, as
  the JAX engines serve them), one launch per batch of same-signature
  specs, ``lower_product`` / ``bounds`` against the JAX
  package's, and the launch geometry.
"""

import jax
import numpy as np
import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from test_torch_data import (JAX, MAX_HT, PORT, assert_same_rows, flat_rows,
                             group_rows, group_schema, jax_rows, make_schema,
                             plain_planes, reference_planes)
from yugabyte_db_tpu.models.datatypes import DataType as JDT
from yugabyte_db_tpu.ops import group_agg as j_group_agg
from yugabyte_db_tpu.storage import expr as JX
from yugabyte_db_tpu_torch.models.datatypes import DataType as TDT
from yugabyte_db_tpu_torch.ops import decode, group_agg, mvcc_resolve
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
from yugabyte_db_tpu_torch.storage import expr as TX

R = 64
NB = group_agg.NUM_BUCKETS
PAD_BLOCKS = 64  # both engines pad a run's block axis to this multiple


def expr(X, e):
    """A storage.expr tree of ``X``'s package from a nested tuple: a str
    is a column, an int a constant, (op, left, right) a BinOp."""
    if isinstance(e, str):
        return X.Col(e)
    if isinstance(e, int):
        return X.Const(e)
    return X.BinOp(e[0], expr(X, e[1]), expr(X, e[2]))


def build(S, X, kw: dict):
    """``S.ScanSpec`` from keyword arguments with (fn, column, expression
    tuple or None, label) aggregates and (column, op, value) predicates."""
    kw = dict(kw)
    kw["aggregates"] = [
        S.AggSpec(fn, col, expr=None if e is None else expr(X, e),
                  label=label) for fn, col, e, label in kw["aggregates"]]
    kw["predicates"] = [S.Predicate(*p) for p in kw.get("predicates", [])]
    return S.ScanSpec(**kw)


DISC_PRICE = ("*", "price", ("-", 100, "disc"))
Q1_AGGS = [("count", None, None, "n"), ("sum", "qty", None, "sum_qty"),
           ("sum", "price", None, "sum_price"),
           ("sum", None, DISC_PRICE, "sum_disc_price"),
           ("sum", None, ("*", DISC_PRICE, ("+", 100, "tax")), "sum_charge")]


def load(rows):
    """The JAX ``tpu`` and ``cpu`` engines and the port's ``gpu`` engine
    (plain versions on the CPU), each with ``rows`` applied and flushed
    into one run."""
    with plain_planes():
        tpu = J.make_engine("tpu", group_schema(JAX), {"rows_per_block": R})
        cpu = J.make_engine("cpu", group_schema(JAX))
        for eng in (tpu, cpu):
            eng.apply(jax_rows(rows))
            eng.flush()
    gpu = T.make_engine("gpu", group_schema(PORT), {"rows_per_block": R,
                                                     "device": "cpu"})
    gpu.apply(rows)
    gpu.flush()
    return {"tpu": tpu, "cpu": cpu, "gpu": gpu}


def null_statuses(rows, max_ht):
    """``rows`` plus, at the next hybrid time, a NULL status written to
    every 7th key: ``tests/test_group_agg.py``'s NULL group values."""
    schema = group_schema(PORT)
    status = schema.column("status").col_id
    keys = list(dict.fromkeys(r.key for r in rows))
    return rows + [PORT.row_version.RowVersion(k, ht=max_ht + 1,
                                                columns={status: None})
                   for k in keys[::7]], max_ht + 1


@pytest.fixture(scope="module")
def tables():
    """The three tables of ``tests/test_group_agg.py``: flat with NULLs
    (and NULL group values written over it, in the same run), one with
    negative prices, and three versions a key."""
    flat, ht = null_statuses(*group_rows(PORT, group_schema(PORT), 1500))
    neg, neg_ht = group_rows(PORT, group_schema(PORT), 800, negatives=True)
    mv, mv_ht = group_rows(PORT, group_schema(PORT), 300, versions=3)
    return {"flat": (load(flat), ht), "negative": (load(neg), neg_ht),
            "mv": (load(mv), mv_ht)}


def cases(ht: dict) -> list:
    """(label, table, spec keyword arguments) of every case."""
    f, n, m = ht["flat"], ht["negative"], ht["mv"]
    return [
        ("q1_shape", "flat", dict(read_ht=f + 1, aggregates=Q1_AGGS,
                                  group_by=["flag", "status"],
                                  predicates=[("d", "<", 900)])),
        ("q6_shape", "flat", dict(read_ht=f + 1, aggregates=[
            ("sum", None, ("*", "price", "disc"), "revenue")],
            predicates=[("qty", "<", 25), ("d", ">=", 100)])),
        ("null_group", "flat", dict(read_ht=f + 1, group_by=["status"],
                                    aggregates=[("count", None, None, None),
                                                ("sum", "qty", None, None)])),
        ("before_nulls", "flat", dict(read_ht=f - 1, group_by=["status"],
                                      aggregates=[("count", None, None,
                                                   None)])),
        ("int32_group_count_col", "flat", dict(
            read_ht=f + 1, group_by=["disc"],
            aggregates=[("count", "qty", None, None),
                        ("sum", "price", None, None)])),
        ("f64_pred", "flat", dict(read_ht=f + 1, group_by=["flag"],
                                  aggregates=[("count", "x", None, None),
                                              ("sum", "d", None, None)],
                                  predicates=[("x", ">=", 50.0)])),
        ("negative_base", "negative", dict(
            read_ht=n + 1, group_by=["flag"],
            aggregates=[("sum", "price", None, None),
                        ("sum", None, DISC_PRICE, None)])),
        ("mv_current", "mv", dict(read_ht=m + 1, group_by=["flag", "status"],
                                  aggregates=[("count", None, None, None),
                                              ("sum", "price", None, None)])),
        ("mv_historical", "mv", dict(read_ht=m - 300, group_by=["flag"],
                                     aggregates=[("sum", "qty", None,
                                                  None)])),
        ("mv_q1", "mv", dict(read_ht=m - 100, aggregates=Q1_AGGS,
                             group_by=["flag", "status"],
                             predicates=[("d", ">=", 250)])),
    ]


CASE_LABELS = [c[0] for c in cases({"flat": 0, "negative": 0, "mv": 0})]


def case(tables, label):
    ht = {name: t[1] for name, t in tables.items()}
    _l, table, kw = next(c for c in cases(ht) if c[0] == label)
    return tables[table][0], kw


def plain_and_jax(e, kws: list) -> tuple:
    """(plan, [(table, JAX outputs)] a spec): the plain version over one
    parameter row per spec of ``kws`` (one signature, one source), and
    the JAX program ``compiled_grouped`` on each spec alone, on the same
    planes (the JAX engine's run uploaded to the port)."""
    tpu, gpu = e["tpu"], e["gpu"]
    jrun = tpu.runs[0]
    preps, wants = [], []
    for kw in kws:
        jspec, pspec = build(J, JX, kw), build(T, TX, kw)
        exact, _superset, _host = tpu._split_predicates(jspec)
        kind, (jsig, ip, fp) = tpu._grouped_prep(jrun, jspec, exact)
        assert kind == "params"
        wants.append(jax.device_get(j_group_agg.compiled_grouped(jsig)(
            jrun.dev.arrays, ip, fp)))
        preps.append(gpu._plan_scan(pspec))
        assert preps[-1].route == ("grouped" if jsig.flat else "mv_grouped")
    plan = group_agg.make_plan(preps[0].sig)
    assert all(group_agg.make_plan(p.sig) is plan for p in preps)
    arrays = DeviceRun.from_reference_planes(
        reference_planes(jrun.crun, PAD_BLOCKS), R, "cpu").arrays
    if preps[0].view_key is not None:
        assert len(preps) == 1
        arrays = mvcc_resolve.resolve_view_plain(
            arrays, *preps[0].read_planes, mvcc_resolve.constant_planes(
                arrays["valid"].shape[0], R, "cpu"))
    params = torch.tensor([plan.param_row(p.row_lo, p.row_hi, p.read_planes,
                                          p.lits) for p in preps],
                          dtype=torch.int32)
    got = group_agg.grouped_aggregate(plan, plan.plane_table(arrays),
                                      params).numpy()
    return plan, list(zip(got, wants))


def assert_same_buckets(plan, got, want) -> None:
    """One spec's table against the JAX program's, bucket by bucket:
    count, rep, key minima and maxima, scanned, negs, each COUNT and n
    exactly, and each sum as a Python int (where no negative input voids
    the JAX program's digit sums)."""
    kp = plan.kp
    assert kp == want["keymin"].shape[1]
    np.testing.assert_array_equal(got[:NB, 0], want["count"][:NB])
    np.testing.assert_array_equal(got[:NB, 1], want["rep"][:NB])
    np.testing.assert_array_equal(got[:NB, 2:2 + kp], want["keymin"][:NB])
    np.testing.assert_array_equal(got[:NB, 2 + kp:2 + 2 * kp],
                                  want["keymax"][:NB])
    assert got[NB, 0] == int(want["scanned"]) > 0
    assert got[NB, 1] == int(want["negs"])
    for i, (ga, off) in enumerate(zip(plan.sig.aggs, plan.offsets)):
        if ga.kind == "count":
            np.testing.assert_array_equal(got[:NB, off], want[f"a{i}"][:NB])
            continue
        np.testing.assert_array_equal(got[:NB, off], want[f"n{i}"][:NB])
        if int(want["negs"]):
            continue
        for b in np.nonzero(want["count"][:NB])[0]:
            digits = want[f"a{i}"][b]
            assert plan.sum_value(got[b], i) == sum(
                int(d) << (16 * k) for k, d in enumerate(digits)), (i, b)
    assert (got[:NB, 0] > 0).sum() >= 1


@pytest.mark.parametrize("label", CASE_LABELS)
def test_plain_version_matches_jax_bucket_by_bucket(tables, label):
    e, kw = case(tables, label)
    plan, [(got, want)] = plain_and_jax(e, [kw])
    assert_same_buckets(plan, got, want)
    assert (int(want["negs"]) > 0) == (label == "negative_base")


@pytest.fixture(scope="module")
def flat_table():
    """A flat run (one version a key): every read point reads the same
    planes, so specs at distinct read points share one launch."""
    rows, ht = group_rows(PORT, group_schema(PORT), 900, seed=11)
    e = load(rows)
    assert e["gpu"].runs[0].flat
    return e, ht


@pytest.mark.parametrize("label", ["q1_mixed", "q1_wide"])
def test_plain_version_matches_jax_on_batches(flat_table, label):
    """K8's cases past one spec and its slots: 8 Q1 specs at distinct
    cut-offs and read points in one parameter table, and Q1's aggregates
    grouped by (tax, flag): 27 live groups, more than a block's SLOTS."""
    e, ht = flat_table
    q1 = dict(aggregates=Q1_AGGS, group_by=["flag", "status"])
    if label == "q1_mixed":
        kws = [dict(q1, read_ht=ht + 1 - 97 * i,
                    predicates=[("d", "<", 900 - 50 * i)]) for i in range(8)]
    else:
        kws = [dict(q1, read_ht=ht + 1, group_by=["tax", "flag"],
                    predicates=[("d", "<", 900)])]
    plan, pairs = plain_and_jax(e, kws)
    for got, want in pairs:
        assert_same_buckets(plan, got, want)
    live = [int((got[:NB, 0] > 0).sum()) for got, _want in pairs]
    if label == "q1_wide":
        assert live[0] > group_agg.SLOTS
    else:
        assert len({int(got[NB, 0]) for got, _want in pairs}) == 8


@pytest.mark.parametrize("label", CASE_LABELS)
def test_engine_matches_jax_engines(tables, label):
    e, kw = case(tables, label)
    folds0 = e["gpu"].grouped_host_folds
    got = e["gpu"].scan(build(T, TX, kw))
    want = e["tpu"].scan(build(J, JX, kw))
    assert_same_rows(want, got, label)
    assert_same_rows(e["cpu"].scan(build(J, JX, kw)), got, label,
                     scanned=False)
    # Negative bases re-serve on the host, as the JAX engine does; the
    # int32 column's 11 values and the rest hash without a collision.
    assert e["gpu"].grouped_host_folds - folds0 == (
        1 if label == "negative_base" else 0)
    if label == "int32_group_count_col":
        assert len(got.rows) == 11
    if label == "q1_shape":
        assert len(got.rows) == 9  # 3 flags x (F, O, NULL)


def test_collision_is_reserved_on_the_host(tables):
    """More than NUM_BUCKETS distinct group values collide; the spec is
    re-served by the host fold and stays exact."""
    e, _kw = case(tables, "q1_shape")
    kw = dict(read_ht=tables["flat"][1] + 1, group_by=["d"],
              aggregates=[("count", None, None, None),
                          ("sum", None, DISC_PRICE, None)],
              predicates=[("qty", ">", 3)])
    folds0 = e["gpu"].grouped_host_folds
    got = e["gpu"].scan(build(T, TX, kw))
    assert e["gpu"].grouped_host_folds == folds0 + 1
    assert len(got.rows) > NB
    assert_same_rows(e["tpu"].scan(build(J, JX, kw)), got, "collision")
    assert_same_rows(e["cpu"].scan(build(J, JX, kw)), got, "collision",
                     scanned=False)


def test_bounds_and_empty_ranges_match_jax(tables):
    e, kw = case(tables, "q1_shape")
    crun = e["gpu"].runs[0].crun
    lo, hi = crun.key_at(R + 5), crun.key_at(5 * R + 17)
    for lower, upper in ((lo, hi), (hi, lo), (lo, lo), (b"", lo)):
        for with_group in (True, False):
            k = dict(kw, lower=lower, upper=upper)
            if not with_group:
                k.pop("group_by")
            got = e["gpu"].scan(build(T, TX, k))
            assert_same_rows(e["tpu"].scan(build(J, JX, k)), got,
                             (lower, upper))
            assert_same_rows(e["cpu"].scan(build(J, JX, k)), got,
                             (lower, upper), scanned=False)


def test_batch_of_literals_and_read_points_is_one_launch(monkeypatch):
    """On a flat run every read point reads the same planes: one K8
    launch serves the batch."""
    rows, ht = group_rows(PORT, group_schema(PORT), 900, seed=11)
    e = load(rows)
    assert e["gpu"].runs[0].flat
    kw = dict(aggregates=Q1_AGGS, group_by=["flag", "status"])
    specs = [dict(kw, read_ht=ht + 1 - 97 * i,
                  predicates=[("d", "<", 900 - 50 * i)]) for i in range(6)]
    specs.append(dict(kw, read_ht=ht + 1, predicates=[("d", "<", 10)]))
    calls = []
    wrapper = group_agg.grouped_aggregate

    def counted(plan, table, params):
        calls.append(params.shape[0])
        return wrapper(plan, table, params)

    monkeypatch.setattr(group_agg, "grouped_aggregate", counted)
    got = e["gpu"].scan_batch([build(T, TX, k) for k in specs])
    assert calls == [len(specs)]
    want = e["tpu"].scan_batch([build(J, JX, k) for k in specs])
    for k, g, w in zip(specs, got, want):
        assert_same_rows(w, g, k["read_ht"])


def test_memtable_before_the_first_flush_matches_jax():
    rows, ht = group_rows(PORT, group_schema(PORT), 300, seed=3)
    tpu = J.make_engine("tpu", group_schema(JAX), {"rows_per_block": R})
    tpu.apply(jax_rows(rows))
    gpu = T.make_engine("gpu", group_schema(PORT), {"rows_per_block": R,
                                                     "device": "cpu"})
    gpu.apply(rows)
    kw = dict(read_ht=ht + 1, aggregates=Q1_AGGS, group_by=["status"],
              predicates=[("d", "<", 700)])
    assert_same_rows(tpu.scan(build(J, JX, kw)),
                     gpu.scan(build(T, TX, kw)), "memtable")
    assert gpu.memtable_scans == 1


def test_refusals_name_item_7():
    """The specs this test once saw refused are served as the JAX engines
    serve them: a key group column, string group values past 8 bytes,
    MIN under GROUP BY and an expression the device cannot lower through
    the gather (K7), and a grouped scan over several sources through the
    row scan (K9). Rows and ``rows_scanned`` equal the ``tpu`` engine's,
    rows the ``cpu`` engine's."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    rows, ht = flat_rows(PORT, ps, 300, seed=2)
    gpu = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    with plain_planes():
        tpu = J.make_engine("tpu", js, {"rows_per_block": R})
        cpu = J.make_engine("cpu", js)
        for eng in (tpu, cpu, gpu):
            eng.apply(rows if eng is gpu else jax_rows(rows))
            eng.flush()

        def specs(S, X):
            count = [S.AggSpec("count", None)]
            return [
                S.ScanSpec(read_ht=ht + 1, aggregates=count, group_by=["k"]),
                S.ScanSpec(read_ht=ht + 1, aggregates=count, group_by=["b"]),
                S.ScanSpec(read_ht=ht + 1,
                           aggregates=[S.AggSpec("min", "a")],
                           group_by=["d"]),
                S.ScanSpec(read_ht=ht + 1, aggregates=[S.AggSpec(
                    "sum", None, expr=X.BinOp("*", X.Col("a"),
                                              X.Col("d")))]),
            ]

        def check(label):
            for i, (g, j) in enumerate(zip(specs(T, TX), specs(J, JX))):
                got = gpu.scan(g)
                assert_same_rows(tpu.scan(j), got, (label, i))
                assert_same_rows(cpu.scan(j), got, (label, i),
                                 scanned=False)

        check("one run")
        # A live memtable: five keys rewritten after the flush.
        more = [PORT.row_version.RowVersion(
            r.key, ht=ht + r.ht, tombstone=r.tombstone, liveness=r.liveness,
            columns=r.columns) for r in flat_rows(PORT, ps, 5, seed=3)[0]]
        for eng in (tpu, cpu, gpu):
            eng.apply(more if eng is gpu else jax_rows(more))
        check("several sources")
        kw = dict(read_ht=MAX_HT, group_by=["d"])
        got = gpu.scan(T.ScanSpec(aggregates=[T.AggSpec("count", None)],
                                  **kw))
        want = J.ScanSpec(aggregates=[J.AggSpec("count", None)], **kw)
        assert_same_rows(tpu.scan(want), got, "grouped over sources")
        assert_same_rows(cpu.scan(want), got, "grouped over sources",
                         scanned=False)


DTYPES = {"qty": "INT64", "price": "INT64", "disc": "INT8", "tax": "INT8",
          "d": "INT32", "x": "DOUBLE", "flag": "STRING", "small": "INT16",
          "ok": "BOOL"}
EXPRS = [
    DISC_PRICE, ("*", DISC_PRICE, ("+", 100, "tax")), ("*", "price", "disc"),
    ("*", "d", ("-", 100, "disc")), ("*", "qty", "d"), ("*", "price", "x"),
    ("*", "price", ("*", "small", "disc")), ("*", "price", "small"),
    ("*", "price", "ok"), ("*", ("*", "price", "disc"), ("*", "tax", "ok")),
    ("*", "disc", "tax"), ("+", "price", "disc"), "price",
    ("*", ("*", ("*", "price", "disc"), "tax"), "ok"),
    ("*", "price", ("-", "disc", "tax")), ("*", "price", "flag"),
]


def _tuple(X, e):
    """An expression of either package back to the nested-tuple form."""
    if isinstance(e, X.Col):
        return e.name
    if isinstance(e, X.Const):
        return e.value
    return (e.op, _tuple(X, e.left), _tuple(X, e.right))


@pytest.mark.parametrize("e", EXPRS, ids=str)
def test_lower_product_and_bounds_match_jax(e):
    def j_dtype(name):
        return getattr(JDT, DTYPES[name])

    def t_dtype(name):
        return getattr(TDT, DTYPES[name])

    want = JX.lower_product(expr(JX, e), j_dtype)
    got = TX.lower_product(expr(TX, e), t_dtype)
    if want is None:
        assert got is None
    else:
        assert got[0] == want[0]
        assert [_tuple(TX, f) for f in got[1]] == \
            [_tuple(JX, f) for f in want[1]]
    try:
        jb = JX.bounds(expr(JX, e), j_dtype)
    except ValueError:
        with pytest.raises(ValueError):
            TX.bounds(expr(TX, e), t_dtype)
    else:
        assert TX.bounds(expr(TX, e), t_dtype) == jb


# TPC-H Q1's shape on the group table: the staged words of a row (hybrid
# time, expiry, row word; d, flag and status's order planes; four limbs
# for each of 4 sums) and one spec's records (16 slots of 8 64-bit and 19
# 32-bit words, a 7-word parameter row).
Q1_TILE = 4 * 128 * 4 * (5 + 1 + 2 + 2 + 4 * 4)
Q1_SPEC = 16 * -(-(16 * (8 * 8 + 4 * 19) + 4 * 7) // 16)


def plain_geometry(blocks, chunks, chunk, smem):
    """The Geometry of a launch over plain planes (the plain build)."""
    return group_agg.Geometry(
        encoded=0, threads=128, blocks=blocks, chunks=chunks, chunk=chunk,
        smem_bytes=smem, raw_bytes=0, buffers=0, dict_bytes=0, copied_lo=0,
        copied_hi=0, dict_shared=0, dict_cached=0)


def test_launch_geometry():
    assert (Q1_TILE, Q1_SPEC) == (53_248, 2_272)
    seen = []

    def per_sm(smem):
        seen.append(smem)
        return 3

    geo = group_agg.launch_geometry(1, 6_001_215, Q1_TILE, Q1_SPEC, 132,
                                    per_sm)
    assert geo == plain_geometry(3 * 132, 1, 1, Q1_TILE + Q1_SPEC)
    assert seen == [Q1_TILE + Q1_SPEC]  # the occupancy of this block
    # 8 specs: one chunk, one wave of 396 blocks reading the planes once.
    geo = group_agg.launch_geometry(8, 6_001_215, Q1_TILE, Q1_SPEC, 132,
                                    per_sm)
    assert geo == plain_geometry(396, 1, 8, Q1_TILE + 8 * Q1_SPEC)
    # 37 specs: 3 balanced chunks of 13 share the wave.
    geo = group_agg.launch_geometry(37, 6_001_215, Q1_TILE, Q1_SPEC, 132,
                                    per_sm)
    assert (geo.blocks, geo.chunk, geo.chunks) == (132, 13, 3)
    # No more blocks than the pieces need: 79 pieces of 128 rows, 4 a
    # block.
    assert group_agg.launch_geometry(1, 10_000, Q1_TILE, Q1_SPEC, 132,
                                     per_sm).blocks == 20
    assert group_agg.launch_geometry(1, 0, Q1_TILE, Q1_SPEC, 132,
                                     per_sm).blocks == 1
    assert group_agg.launch_geometry(65535, 10**8, Q1_TILE, Q1_SPEC, 132,
                                     per_sm).blocks == 1
    with pytest.raises(ValueError):
        group_agg.launch_geometry(0, 100, Q1_TILE, Q1_SPEC, 132, per_sm)
    with pytest.raises(ValueError):
        group_agg.launch_geometry(65536, 100, Q1_TILE, Q1_SPEC, 132, per_sm)
    with pytest.raises(ValueError):
        group_agg.launch_geometry(
            1, 100, group_agg.SMEM_LIMIT - group_agg.STATIC_SMEM, Q1_SPEC,
            132, per_sm)
    with pytest.raises(ValueError):
        group_agg.launch_geometry(1, 100, Q1_TILE, Q1_SPEC,
                                  132, lambda smem: 0)


def _signature(n_cols: int, kind: str, n_preds: int, n_group: int,
               n_aggs: int) -> group_agg.GroupAggSig:
    """A signature of n_cols columns of ``kind``: predicates and group
    columns on distinct columns, sums of a column times two factors."""
    from yugabyte_db_tpu_torch.ops.scan import ColSig, PredSig

    cols = tuple(ColSig(c, kind) for c in range(n_cols))
    preds = tuple(PredSig(c % n_cols, "i64" if kind != "i32" else "i32",
                          "<") for c in range(n_preds))
    group = tuple((c % n_cols, 2 if kind != "i32" else 1)
                  for c in range(n_preds, n_preds + n_group))
    factors = (("-", ("k", 100), ("c", 0)), ("*", ("c", 1 % n_cols),
                                             ("k", 3)))
    aggs = tuple(group_agg.GAgg("sum_prod", a % n_cols,
                                2 if kind != "i32" else 1, factors,
                                (a % n_cols, 0, 1 % n_cols))
                 for a in range(n_aggs))
    return group_agg.GroupAggSig(NB, cols, preds, group, aggs)


SIGNATURES = {
    "widest": (16, "i64", 8, 4, 8),   # the descriptor's maxima
    "wide_i32": (16, "i32", 8, 4, 8),
    "q1_like": (8, "str", 1, 2, 5),
    "count_only": (1, "i32", 0, 0, 1),
}


@pytest.mark.parametrize("n_specs", [1, 8, 64, 65_535])
@pytest.mark.parametrize("name", list(SIGNATURES))
def test_every_eligible_signature_fits_a_block(name, n_specs):
    """Every signature the descriptor takes gets a geometry within the
    block's 232,448 shared bytes, and its chunks cover every spec once."""
    sig = _signature(*SIGNATURES[name])
    assert group_agg.eligible(sig)
    plan = group_agg.make_plan(sig)
    geo = group_agg.launch_geometry(n_specs, 6_001_215, plan.tile_bytes,
                                    plan.spec_bytes, 132, lambda smem: 1)
    assert geo.smem_bytes == plan.tile_bytes + geo.chunk * plan.spec_bytes
    assert geo.smem_bytes + group_agg.STATIC_SMEM <= group_agg.SMEM_LIMIT
    assert group_agg.SMEM_LIMIT == 232_448
    assert 1 <= geo.chunk <= group_agg.SPEC_CHUNK and geo.chunks <= 65_535
    covered = [s for c in range(geo.chunks)
               for s in range(c * geo.chunk, min(n_specs, (c + 1) * geo.chunk))]
    assert covered == list(range(n_specs))
    assert (geo.chunks - 1) * geo.chunk < n_specs  # no empty chunk
    assert geo.blocks * geo.chunks <= max(132, geo.chunks)  # one wave


def test_plan_layout_and_descriptor(tables):
    e, kw = case(tables, "q1_shape")
    prep = e["gpu"]._plan_scan(build(T, TX, kw))
    plan = group_agg.make_plan(prep.sig)
    assert plan.kp == 6 and plan.n_out == 2 + 12 + 1 + 4 * 3
    assert (plan.tile_bytes, plan.spec_bytes) == (Q1_TILE, Q1_SPEC)
    assert plan.n_params == group_agg.PARAM_HEAD + 1
    table = plan.plane_table(e["gpu"].runs[0].dev.arrays)
    w = plan.descriptor(table)
    assert len(w) == group_agg.DESC_WORDS
    assert list(w[:7]) == [len(plan.col_ids), 1, 2, 5, plan.n_params, 6,
                           plan.n_out]
    # sum_disc_price's factor (100 - disc) in postfix: 100, disc, -.
    at = (7 + group_agg.MAX_COLS + 4 * group_agg.MAX_PREDS
          + 2 * group_agg.MAX_GROUP + 6 * group_agg.MAX_AGGS
          + 2 * group_agg.MAX_NODES * group_agg.MAX_FACTORS * 3)
    disc = plan.slot[group_schema(PORT).column("disc").col_id]
    assert list(w[at:at + 8]) == [1, 100, 2, disc, 4, 0, 0, 0]
    assert not group_agg.eligible(group_agg.GroupAggSig(
        NB, prep.sig.cols, prep.sig.preds, prep.sig.group_cols * 3,
        prep.sig.aggs))  # more group columns than the descriptor holds



def _encoded_table(plan, variant: str, B: int = 2, R: int = 128) -> list:
    """A plane table for ``plan`` whose planes are all encoded: delta16
    hybrid times, bits flags, each group column a 2-entry dictionary and
    every other order plane delta16 (``"copies"``: the largest copy of a
    piece) or, for the staged columns, a dictionary, their entries
    together DICT_SMEM_CAP bytes (``"dicts"``)."""
    i16 = lambda *s: torch.zeros(s, dtype=torch.int16)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    bits = lambda: {"bits": {"bw": i32(B, R // 32)}}
    dct = lambda d: {"dict": {"codes": i16(B, R), "dhi": i32(d),
                              "dlo": i32(d)}}

    def delta(width):
        return {"delta16": {"dbase": i32(B, 1, *([width] * (width > 1))),
                            "doff": i16(B, R, *([width] * (width > 1)))}}

    group = {plan.slot[c] for c, _p in plan.sig.group_cols}
    values = sorted(group_agg.value_cols(plan) - group)
    rest = group_agg.DICT_SMEM_CAP // 8 - 2 * len(group)
    entries = {c: rest // len(values) + (c == values[-1]) * (
        rest % len(values)) for c in values} if variant == "dicts" else {}
    two = {c.col_id: c.two_plane for c in plan.sig.cols}
    table = [delta(1) for _ in range(4)] + [bits() for _ in range(3)]
    for k, cid in enumerate(plan.col_ids):
        cmp = (dct(2) if k in group else dct(entries[k]) if k in entries
               else delta(1 + two[cid]))
        table += [bits(), bits(), cmp]
    return table


@pytest.mark.parametrize("variant", ["copies", "dicts"])
@pytest.mark.parametrize("n_specs", [1, 8, 64, 65_535])
@pytest.mark.parametrize("name", list(SIGNATURES))
def test_every_eligible_signature_fits_a_block_encoded(name, n_specs,
                                                       variant):
    """Every signature the descriptor takes, over planes that are all
    encoded, gets a launch within the block's shared bytes: the copies
    (one spec a chunk) beside the dictionaries, or the dictionaries at
    DICT_SMEM_CAP, all in shared memory; its chunks cover every spec
    once."""
    sig = _signature(*SIGNATURES[name])
    assert group_agg.eligible(sig)
    plan = group_agg.make_plan(sig)
    table = _encoded_table(plan, variant)
    layout, geo = group_agg.plan_launch(plan, table, n_specs, 132,
                                        lambda smem, build: 1)
    assert geo.smem_bytes == (plan.tile_bytes + geo.chunk * plan.spec_bytes
                              + group_agg.WARPS * geo.buffers
                              * layout.raw_bytes + layout.dict_bytes
                              + group_agg.copy_table_bytes(layout))
    assert geo.smem_bytes + group_agg.STATIC_SMEM <= group_agg.SMEM_LIMIT
    n_group = len(sig.group_cols)
    assert layout.dict_bytes == (group_agg.DICT_SMEM_CAP if variant == "dicts"
                                 else -(-16 * n_group // 16) * 16)
    assert layout.dict_cached == 0
    assert (geo.buffers > 0) == (n_specs == 1)  # copies for one spec
    assert layout.raw_bytes == (geo.raw_bytes if geo.buffers else 0)
    covered = [s for c in range(geo.chunks)
               for s in range(c * geo.chunk, min(n_specs, (c + 1) * geo.chunk))]
    assert covered == list(range(n_specs))
    assert geo.blocks * geo.chunks <= max(132, geo.chunks)  # one wave


# Encoded layouts on Q1's shape: a piece's copy of the compacted SF1
# lineitem's copied leaves (17 bits planes, five u16 planes), lineitem's
# two 4-entry dictionaries, a dictionary-only layout and one whose copy
# is too large for two buffers of this tile.
LAYOUTS = {
    "compacted": (1808, 64),
    "dicts_only": (0, 64),
    "big_copy": (9_792, 0),
}


@pytest.mark.parametrize("drop_at", [None, 70_000])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_launch_geometry_with_copies_and_dictionaries(name, drop_at):
    """An encoded layout adds each warp's buffers (two where the SM holds
    as many blocks as with one, else one; none without a copy), the
    dictionaries and the copy's tables (16 bytes a copied plane, 2 a
    16-byte chunk) to the block's shared bytes, and the geometry reports
    the layout."""
    raw, dicts = LAYOUTS[name]
    layout = group_agg.CopyLayout(True, (), (), raw, dicts, (1 << 40) | 7,
                                  0b110000, 0b1)
    per_sm = (lambda smem: 3) if drop_at is None else (
        lambda smem: 3 if smem <= drop_at else 2)
    geo = group_agg.launch_geometry(1, 6_001_215, Q1_TILE, Q1_SPEC, 132,
                                    per_sm, layout)
    # The copy's tables: 16 bytes a copied plane (4 here), 2 a chunk.
    base = Q1_TILE + Q1_SPEC + dicts + -(-(64 + raw // 8) // 16) * 16
    want = 0 if not raw else 2 if per_sm(base + 8 * raw) >= per_sm(
        base + 4 * raw) else 1
    assert geo.buffers == want
    assert geo.smem_bytes == base + group_agg.WARPS * want * raw
    assert geo.blocks == per_sm(geo.smem_bytes) * 132
    assert (geo.encoded, geo.raw_bytes, geo.dict_bytes) == (1, raw, dicts)
    assert (geo.copied_lo, geo.copied_hi) == (7, 1 << 8)
    assert (geo.dict_shared, geo.dict_cached) == (0b110000, 0b1)
    if name == "compacted" and drop_at is not None:
        assert geo.buffers == 1  # two would cost a block an SM
    with pytest.raises(ValueError):  # no buffer fits this tile
        group_agg.launch_geometry(
            1, 100, group_agg.SMEM_LIMIT - group_agg.STATIC_SMEM - 4 * raw
            - base + Q1_TILE + 16, Q1_SPEC, 132, lambda smem: 1,
            layout._replace(raw_bytes=raw or 16))


@pytest.fixture(scope="module")
def encoded_table():
    """The port's ``gpu`` engine (CPU tensors, ``plane_encoding``
    "auto") on the grouped table, flushed and compacted (bits flags,
    dictionaries, delta16 and const leaves), and Q1's plan over it."""
    rows, ht = group_rows(PORT, group_schema(PORT), 3000, seed=5)
    eng = T.make_engine("gpu", group_schema(PORT), {
        "rows_per_block": R, "device": "cpu", "plane_encoding": "auto"})
    eng.apply(rows)
    eng.flush()
    eng.compact(1)
    spec = build(T, TX, dict(read_ht=ht + 1, aggregates=Q1_AGGS,
                             group_by=["flag", "status"],
                             predicates=[("d", "<", 900)]))
    plan = group_agg.make_plan(eng._plan_scan(spec).sig)
    return plan, eng.runs[0].dev.arrays


@pytest.mark.parametrize("reads_dict", [False, True])
def test_unread_encoded_leaves_take_the_plain_build(reads_dict):
    """A flushed run encodes only its string columns (dictionaries): a
    signature that reads none of them takes the plain build (no layout),
    one grouped by them the encoded build."""
    rows, ht = group_rows(PORT, group_schema(PORT), 600, seed=9)
    eng = T.make_engine("gpu", group_schema(PORT), {
        "rows_per_block": R, "device": "cpu", "plane_encoding": "auto"})
    eng.apply(rows)
    eng.flush()
    kw = dict(read_ht=ht + 1, aggregates=Q1_AGGS, predicates=[("d", "<", 900)])
    if reads_dict:
        kw["group_by"] = ["flag", "status"]
    plan = group_agg.make_plan(eng._plan_scan(build(T, TX, kw)).sig)
    table = plan.plane_table(eng.runs[0].dev.arrays)
    assert any(group_agg.enc.leaf_kind(t) == "dict" for t in table)
    assert group_agg.copy_layout(plan, table).encoded == reads_dict
    # The dictionaries' codes are a small share of a piece: not copied.
    layout, geo = group_agg.plan_launch(plan, table, 1, 132,
                                        lambda smem, build: 2)
    assert group_agg.build_of(layout) == (1 if reads_dict else 0)
    assert (geo.encoded, geo.buffers) == (int(reads_dict), 0)


def _misaligned(arrays: dict, cid: int) -> dict:
    """``arrays`` with column ``cid``'s delta16 offsets moved 2 bytes past
    a 16-byte boundary."""
    leaf = arrays["cols"][cid]["cmp"]["delta16"]
    doff = leaf["doff"]
    moved = torch.empty(doff.numel() + 8, dtype=doff.dtype)[1:][
        :doff.numel()].view(doff.shape)
    moved.copy_(doff)
    cols = dict(arrays["cols"])
    cols[cid] = dict(cols[cid], cmp={"delta16": dict(leaf, doff=moved)})
    return dict(arrays, cols=cols)


COPY_CASES = ("plain", "encoded", "misaligned", "dict_cap", "no_copies")


@pytest.mark.parametrize("case", COPY_CASES)
def test_copy_layout(encoded_table, case):
    """Which planes the encoded build copies (the 16-byte aligned per-row
    arrays of the planes the staging reads, back to back in plane order:
    a bits plane's 16 bytes a piece, 256 a u16 array a plane word), which
    it loads from the run (a misaligned array, every plain plane), and
    which dictionaries it keeps in shared memory (the staged columns',
    within DICT_SMEM_CAP) or reads through the read-only cache; the leaf
    words carry the same offsets."""
    from yugabyte_db_tpu_torch.ops import encodings as enc

    plan, arrays = encoded_table
    schema = group_schema(PORT)
    kw = {}
    if case == "plain":
        arrays = decode.decode_tree_plain(arrays)
    elif case == "misaligned":
        disc = schema.column("disc").col_id
        assert enc.leaf_kind(arrays["cols"][disc]["cmp"]) == "delta16"
        arrays = _misaligned(arrays, disc)
    elif case == "dict_cap":
        kw["dict_cap"] = 0
    elif case == "no_copies":
        kw["copies"] = False
    table = plan.plane_table(arrays)
    layout = group_agg.copy_layout(plan, table, **kw)
    n = 7 + 3 * len(plan.col_ids)
    _ptrs, words = group_agg.leaf_table(plan, table, layout)
    assert list(words[:, 4]) == list(layout.raw)
    assert list(words[:, 5]) == list(layout.dsh)
    if case == "plain":
        assert layout == group_agg.CopyLayout(False, (-1,) * n, (-1,) * n,
                                              0, 0, 0, 0, 0)
        return
    values = group_agg.value_cols(plan)
    read_cols = values | {plan.slot[c] for c in plan.code_cols}
    off = 0
    for k in range(n):
        kind = enc.leaf_kind(table[k])
        slot = (k - 7) // 3 if k >= 7 else None
        read = k < 9 or (k - 7) % 3 != 2 or slot in read_cols
        array = {"bits": "bw", "delta16": "doff", "rle": "rid",
                 "dict": "codes"}.get(kind)
        copy = (case != "no_copies" and read and array is not None and
                table[k][kind][array].data_ptr() % 16 == 0)
        assert (layout.raw[k] >= 0) == copy, (k, kind)
        assert bool(layout.copied >> k & 1) == copy
        if copy:
            assert layout.raw[k] == off
            off += 16 if kind == "bits" else 256 * (
                group_agg.plane_width(table[k]) if kind == "delta16" else 1)
        if case == "misaligned" and slot == plan.slot[
                schema.column("disc").col_id] and (k - 7) % 3 == 2:
            assert layout.raw[k] == -1  # loaded from the run
    assert layout.raw_bytes == off > 0 if case != "no_copies" else \
        layout.raw_bytes == 0
    # The two string group columns' 4-entry dictionaries: in shared
    # memory in plane order, or, past the cap, through the cache.
    flag, status = (plan.slot[schema.column(c).col_id]
                    for c in ("flag", "status"))
    dict_slots = {slot for slot in range(len(plan.col_ids))
                  if enc.leaf_kind(table[9 + 3 * slot]) == "dict"}
    assert {flag, status} <= dict_slots & values
    want = sum(1 << c for c in dict_slots & values)
    if case == "dict_cap":
        assert (layout.dict_shared, layout.dict_cached) == (0, want)
        assert layout.dict_bytes == 0 and set(layout.dsh) == {-1}
    else:
        assert (layout.dict_shared, layout.dict_cached) == (want, 0)
        entries = [table[9 + 3 * c]["dict"]["dhi"].numel()
                   for c in sorted(dict_slots & values)]
        assert [layout.dsh[9 + 3 * c] for c in sorted(dict_slots & values)] \
            == [sum(entries[:i]) for i in range(len(entries))]
        assert layout.dict_bytes == -(-8 * sum(entries) // 16) * 16
    geo = group_agg.launch_geometry(1, 6_001_215, plan.tile_bytes,
                                    plan.spec_bytes, 132, lambda smem: 2,
                                    layout)
    tables = 16 * bin(layout.copied).count("1") + layout.raw_bytes // 8
    assert geo.smem_bytes == (plan.tile_bytes + plan.spec_bytes
                              + group_agg.WARPS * geo.buffers
                              * layout.raw_bytes + layout.dict_bytes
                              + -(-tables // 16) * 16)


@pytest.mark.parametrize("case", ["q1", "batch", "wide_groups",
                                  "small_share"])
def test_copies_pay(encoded_table, case):
    """The copies go to a chunk of one spec whose groups fit a block's
    slots (dictionary group columns) and whose copied bytes are at least
    a quarter of a piece's staged bytes."""
    plan, arrays = encoded_table
    table = plan.plane_table(arrays)
    layout = group_agg.copy_layout(plan, table)
    assert layout.raw_bytes and layout.loaded_bytes  # both kinds of plane
    chunk = 2 if case == "batch" else 1
    if case == "wide_groups":  # grouped by a numeric column too
        qty = group_schema(PORT).column("qty").col_id
        sig = plan.sig
        plan = group_agg.make_plan(group_agg.GroupAggSig(
            NB, sig.cols, sig.preds, sig.group_cols + ((qty, 2),),
            sig.aggs))
        table = plan.plane_table(arrays)
        layout = group_agg.copy_layout(plan, table)
    if case == "small_share":
        layout = layout._replace(loaded_bytes=3 * layout.raw_bytes + 16)
    assert group_agg.copies_pay(plan, table, layout, chunk) == (case == "q1")
    geo_want = 2 if case == "q1" else 0
    if case != "small_share":
        _layout, geo = group_agg.plan_launch(
            plan, table, chunk, 132, lambda smem, build: 2)
        assert geo.buffers == geo_want


@pytest.mark.parametrize("what", ["copies", "dicts", "none", "occupancy"])
def test_plan_launch_drops_what_does_not_fit(encoded_table, what):
    """Where a block with the copies does not fit shared memory, or holds
    fewer blocks an SM than the same layout without them, the launch
    goes without them (the pieces loaded from the run); where even that
    does not fit (which ``eligible`` rules out for a real block), the
    launch is refused."""
    plan, arrays = encoded_table
    table = plan.plane_table(arrays)
    full = group_agg.copy_layout(plan, table)
    layout, geo = group_agg.plan_launch(plan, table, 1, 132,
                                        lambda s, build: 2)
    assert layout == full and geo.buffers == 2
    base = plan.tile_bytes + plan.spec_bytes + group_agg.STATIC_SMEM
    limit = {"copies": base + full.dict_bytes + 4 * full.raw_bytes
             + group_agg.copy_table_bytes(full) + 16,
             "dicts": base + full.dict_bytes, "none": base,
             "occupancy": group_agg.SMEM_LIMIT}[what]
    bare = base - group_agg.STATIC_SMEM + full.dict_bytes

    def per_sm(smem, build):  # the copies cost a block: "occupancy"
        assert build == (2 if smem > bare else 1)
        return 2 if what != "occupancy" or smem <= bare else 1

    old = group_agg.SMEM_LIMIT
    group_agg.SMEM_LIMIT = limit
    try:
        if what == "none":  # not even the dictionaries fit
            with pytest.raises(ValueError, match="does not fit shared"):
                group_agg.plan_launch(plan, table, 1, 132, per_sm)
            return
        layout, geo = group_agg.plan_launch(plan, table, 1, 132, per_sm)
    finally:
        group_agg.SMEM_LIMIT = old
    assert (layout.raw_bytes > 0) == (what == "copies")
    assert layout.dict_bytes == full.dict_bytes > 0
    assert geo.buffers == (1 if what == "copies" else 0)
    assert geo.raw_bytes == layout.raw_bytes
