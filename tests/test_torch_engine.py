"""The port's ``gpu`` engine against the JAX package's ``cpu`` and ``tpu``.

``make_engine("gpu", ..., {"device": "cpu"})`` (kernels in their plain
PyTorch versions) and the JAX package's two engines take the same rows:
a flat run, and a multi-version history (``multiversion_rows``, one key
past 32 versions, so the ``tpu`` engine takes its ``seg`` route). Every
aggregate spec, alone and in one ``scan_batch_async`` batch (on the
multi-version run, at mixed read points), must give the same column names
and rows as both (integers, counts, MIN and MAX exactly; float sums and
averages within rel 1e-4 / abs 1e-4, the tolerance of
``tests/test_engine_diff.py``) and the ``rows_scanned`` the ``tpu``
engine reports (the ``cpu`` engine counts keys examined, a different
statistic). Row scans and the aggregates the device folds do not take go
down the row path, and must equal both too. The JAX engines upload plain
planes here (``plain_planes``): the port has no plane encodings yet, so a
string predicate takes the same route on both sides.
"""

import weakref

import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from yugabyte_db_tpu.ops import flat_fold as j_flat_fold
from yugabyte_db_tpu.storage import expr as j_expr
from yugabyte_db_tpu_torch.storage import expr as t_expr
from yugabyte_db_tpu_torch.ops import (flat_agg, flat_fold, full_agg,
                                       mvcc_resolve)
from test_torch_data import (JAX, MAX_HT, PORT, assert_same, encode_key,
                             flat_rows, make_schema, multiversion_rows,
                             plain_planes)
from test_torch_data import build_spec as build

R = 64
N_KEYS = 800


@pytest.fixture(scope="module", autouse=True)
def _plain_planes():
    with plain_planes():
        yield


@pytest.fixture(scope="module")
def engines():
    js, ps = make_schema(JAX, "mixed"), make_schema(PORT, "mixed")
    jrows, max_ht = flat_rows(JAX, js, N_KEYS, seed=44)
    prows, _ = flat_rows(PORT, ps, N_KEYS, seed=44)
    cpu = J.make_engine("cpu", js)
    tpu = J.make_engine("tpu", js, {"rows_per_block": R})
    gpu = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    for eng, rows in ((cpu, jrows), (tpu, jrows), (gpu, prows)):
        eng.apply(rows)
        eng.flush()
    return {"js": js, "ps": ps, "cpu": cpu, "tpu": tpu, "gpu": gpu,
            "max_ht": max_ht}


def spec_kwargs(e):
    """(label, spec keyword arguments with (fn, column) aggregates and
    (column, op, value) predicates) of every case."""
    ps, top = e["ps"], e["max_ht"] + 1
    lo_key, hi_key = encode_key(PORT, ps, 200), encode_key(PORT, ps, 560)
    headline = [("count", None), ("sum", "a"), ("min", "a"), ("max", "a"),
                ("sum", "d")]
    return [
        ("headline", dict(read_ht=top, aggregates=headline,
                          predicates=[("d", ">=", -500_000)])),
        ("counts_avg", dict(read_ht=top, aggregates=[
            ("count", "b"), ("count", "c"), ("avg", "a"), ("min", "d"),
            ("max", "d"), ("avg", "d")])),
        ("i64_preds", dict(read_ht=top, aggregates=headline, predicates=[
            ("a", "<", 0), ("d", "!=", 0)])),
        ("f64_fold", dict(read_ht=top, aggregates=[
            ("count", None), ("sum", "c"), ("min", "c"), ("max", "c"),
            ("avg", "c"), ("sum", "a")], predicates=[("c", ">=", 50.0)])),
        ("bounded", dict(lower=lo_key, upper=hi_key, read_ht=top,
                         aggregates=headline)),
        ("mid_history", dict(read_ht=(100 + e["max_ht"]) // 2,
                             aggregates=headline,
                             predicates=[("d", "<=", 250_000)])),
        ("before_all", dict(read_ht=50, aggregates=headline)),
        ("past_the_end", dict(lower=b"\xff\xff", read_ht=top,
                              aggregates=headline)),
    ]


def test_each_spec_alone_matches_cpu_and_tpu(engines):
    e = engines
    for label, kw in spec_kwargs(e):
        got = e["gpu"].scan(build(T, kw))
        assert_same(e["tpu"].scan(build(J, kw)), got, label)
        assert_same(e["cpu"].scan(build(J, kw)), got, label, scanned=False)


def test_routes(engines):
    e = engines
    routes = {label: e["gpu"]._plan_scan(build(T, kw))
              for label, kw in spec_kwargs(e)}
    assert routes.pop("past_the_end").rows == [(0, None, None, None, None)]
    assert routes.pop("f64_fold").route == "flat"
    assert {p.route for p in routes.values()} == {"kernel"}


def test_async_batch_matches_cpu_and_tpu(engines, monkeypatch):
    e = engines
    cases = spec_kwargs(e)
    # Same-signature kernel specs (the headline at distinct literals) ride
    # one call with one parameter row each; the rest group by signature.
    cases += [(f"headline_{lo}", dict(cases[0][1], predicates=[
        ("d", ">=", lo)])) for lo in (-900_000, 0, 400_000, 10**6)]
    calls = []
    wrapper = flat_agg.flat_aggregate

    def counted(plan, table, params):
        calls.append(params.shape[0])
        return wrapper(plan, table, params)

    monkeypatch.setattr(flat_agg, "flat_aggregate", counted)
    batch = e["gpu"].scan_batch_async([build(T, kw) for _l, kw in cases])
    got = batch.finish()
    # headline x5; bounded + before_all; counts_avg; i64_preds; mid_history
    assert sorted(calls) == [1, 1, 1, 2, 5]
    assert batch.finish() is got
    want_tpu = e["tpu"].scan_batch([build(J, kw) for _l, kw in cases])
    for (label, kw), g, w in zip(cases, got, want_tpu):
        assert_same(w, g, label)
        assert_same(e["cpu"].scan(build(J, kw)), g, label, scanned=False)


def test_flat_run_past_the_bounds_takes_the_windowed_fold(engines,
                                                         monkeypatch):
    """Past the flat fold's bounds the float and f64-predicate specs take
    route "full" (K5) on the port and on the JAX ``tpu`` engine; one
    ``scan_batch_async`` batch mixes them with K1 specs on one run: the
    K1 specs keep K1, the K5 specs of one signature share one call, and
    every answer equals both JAX engines'."""
    e = engines
    past_the_bounds(monkeypatch)
    cases = spec_kwargs(e)
    f64 = dict(cases)["f64_fold"]
    cases += [(f"f64_fold_{lo}", dict(f64, predicates=[("c", ">=", lo)]))
              for lo in (-1.0, 25.5, 99.0)]
    cases += [("f64_bounded", dict(f64, lower=dict(cases)["bounded"]["lower"],
                                   upper=dict(cases)["bounded"]["upper"]))]
    routes = {label: e["gpu"]._plan_scan(build(T, kw))
              for label, kw in cases}
    assert routes.pop("past_the_end").rows == [(0, None, None, None, None)]
    full = sorted(label for label, p in routes.items() if p.route == "full")
    assert full == ["f64_bounded", "f64_fold", "f64_fold_-1.0",
                    "f64_fold_25.5", "f64_fold_99.0"]
    assert {p.route for label, p in routes.items()
            if label not in full} == {"kernel"}
    assert jax_route(e["tpu"], build(J, f64)) == "full"
    calls, k1 = [], []
    wrapper, k1_wrapper = full_agg.full_aggregate, flat_agg.flat_aggregate

    def counted(plan, arrays, params):
        calls.append(params.shape[0])
        return wrapper(plan, arrays, params)

    def counted_k1(plan, table, params):
        k1.append(params.shape[0])
        return k1_wrapper(plan, table, params)

    monkeypatch.setattr(full_agg, "full_aggregate", counted)
    monkeypatch.setattr(flat_agg, "flat_aggregate", counted_k1)
    before = e["gpu"].stats()["agg_routes"]["full"]
    batch = e["gpu"].scan_batch_async([build(T, kw) for _l, kw in cases])
    got = batch.finish()
    assert calls == [5]  # one launch for the five K5 specs
    assert sum(k1) == len(cases) - 6  # the rest but past_the_end
    assert e["gpu"].stats()["agg_routes"]["full"] == before + 5
    for (label, kw), g in zip(cases, got):
        assert_same(e["tpu"].scan(build(J, kw)), g, label)
        assert_same(e["cpu"].scan(build(J, kw)), g, label, scanned=False)


def test_overlay_past_the_bounds_takes_the_windowed_fold(monkeypatch):
    """The delta overlay's masked primary past the flat fold's bounds: a
    float spec takes route "full" on it, and the answer (the masked
    primary's K5 partial and the dirty keys' host partial) equals both
    JAX engines'."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    rows, max_ht = flat_rows(PORT, ps, 600, seed=9)
    jrows, _ = flat_rows(JAX, js, 600, seed=9)
    sides = {"gpu": (T, T.make_engine("gpu", ps, {"rows_per_block": R,
                                                   "device": "cpu"}),
                     rows, PORT),
             "tpu": (J, J.make_engine("tpu", js, {"rows_per_block": R}),
                     jrows, JAX),
             "cpu": (J, J.make_engine("cpu", js), jrows, JAX)}
    for _S, eng, rs, side in sides.values():
        eng.apply(rs)
        eng.flush()
        cid = {c.name: c.col_id for c in eng.schema.value_columns}
        eng.apply([side.row_version.RowVersion(
            rs[k].key, ht=max_ht + 1 + k, liveness=True,
            columns={cid["c"]: 1000.0 + k}) for k in range(0, 600, 7)]
            + [side.row_version.RowVersion(rs[k].key, ht=max_ht + 1 + k,
                                           tombstone=True)
               for k in range(3, 600, 41)])
    past_the_bounds(monkeypatch)
    kws = [dict(read_ht=max_ht + 700, aggregates=[
                ("count", None), ("sum", "c"), ("min", "c"), ("max", "c"),
                ("avg", "c"), ("sum", "a")], predicates=[("c", ">=", 40.0)]),
           dict(read_ht=max_ht + 300, aggregates=[("max", "c"),
                                                  ("count", "d")])]
    gpu = sides["gpu"][1]
    for i, kw in enumerate(kws):
        prep = gpu._plan_scan(build(T, kw))
        assert prep.overlay is not None and prep.route == "full", i
        got = gpu.scan(build(T, kw))
        assert_same(sides["tpu"][1].scan(build(J, kw)), got, i)
        assert_same(sides["cpu"][1].scan(build(J, kw)), got, i,
                    scanned=False)
    assert gpu.stats()["agg_routes"]["full"] == len(kws)


def test_out_of_slice_specs_raise(engines):
    """The specs this test once saw refused (a row scan, a LIMIT page,
    string, IN and key-column predicates, MIN of a string, MAX of a key
    column) are served by the row path: the same rows, resume key and
    ``rows_scanned`` as the ``tpu`` engine, the same rows as ``cpu``."""
    e = engines
    top = e["max_ht"] + 1

    def specs(S):
        count = [S.AggSpec("count", None)]
        return [
            S.ScanSpec(read_ht=top),                             # row scan
            S.ScanSpec(read_ht=top, limit=5),
            S.ScanSpec(read_ht=top, aggregates=count,
                       predicates=[S.Predicate("b", "=", "xy")]),
            S.ScanSpec(read_ht=top, aggregates=count,
                       predicates=[S.Predicate("d", "IN", (1, 2))]),
            S.ScanSpec(read_ht=top, aggregates=count,
                       predicates=[S.Predicate("r", ">=", 3)]),
            S.ScanSpec(read_ht=top, aggregates=[S.AggSpec("min", "b")]),
            S.ScanSpec(read_ht=top, aggregates=[S.AggSpec("max", "r")]),
        ]

    for i, (g, j) in enumerate(zip(specs(T), specs(J))):
        got, want = e["gpu"].scan(g), e["tpu"].scan(j)
        assert (got.columns, got.rows, got.resume_key, got.rows_scanned) \
            == (want.columns, want.rows, want.resume_key,
                want.rows_scanned), i
        c = e["cpu"].scan(j)
        assert (got.columns, got.rows, got.resume_key) == \
            (c.columns, c.rows, c.resume_key), i


def test_grouped_and_expression_specs_match_cpu_and_tpu(engines):
    """GROUP BY and expression aggregates, once refused, are served as the
    JAX engines serve them: a group column of more than 512 values (its
    collisions re-served on the host), a narrow one through K8, and an
    expression sum."""
    e = engines
    top = e["max_ht"] + 1

    def specs(S, X):
        times3 = X.BinOp("*", X.Col("a"), X.Const(3))
        return {
            "group_d": S.ScanSpec(read_ht=top, group_by=["d"], aggregates=[
                S.AggSpec("count", None), S.AggSpec("sum", "a"),
                S.AggSpec("count", "c")]),
            "group_d_narrow": S.ScanSpec(
                read_ht=top, group_by=["d"],
                predicates=[S.Predicate("d", ">=", 900_000)],
                aggregates=[S.AggSpec("count", None),
                            S.AggSpec("sum", "a")]),
            "expr": S.ScanSpec(read_ht=top, aggregates=[
                S.AggSpec("sum", None, expr=times3),
                S.AggSpec("count", None)]),
        }

    want = specs(J, j_expr)
    for label, spec in specs(T, t_expr).items():
        got = e["gpu"].scan(spec)
        w = e["tpu"].scan(want[label])
        assert (got.columns, got.rows, got.rows_scanned) == \
            (w.columns, w.rows, w.rows_scanned), label
        c = e["cpu"].scan(want[label])
        assert (got.columns, got.rows) == (c.columns, c.rows), label
    assert len(e["gpu"].scan(specs(T, t_expr)["group_d"]).rows) > 512


def test_multi_source_and_multi_version_runs_raise():
    """A live memtable beside a run, and a second run, are served through
    the delta overlay as the JAX engines serve them; a dirty set larger
    than half the primary run is served by the row scan over the sources,
    as the JAX engines serve it. A run with a second version of a key is
    served, as the JAX engines serve it."""
    ps, js = make_schema(PORT, "mixed"), make_schema(JAX, "mixed")
    rows, max_ht = flat_rows(PORT, ps, 200, seed=5)
    jrows, _ = flat_rows(JAX, js, 200, seed=5)
    sides = {"gpu": (T, T.make_engine("gpu", ps, {"rows_per_block": R,
                                                   "device": "cpu"}),
                     rows, PORT),
             "tpu": (J, J.make_engine("tpu", js, {"rows_per_block": R}),
                     jrows, JAX),
             "cpu": (J, J.make_engine("cpu", js), jrows, JAX)}

    def scans():
        return {name: e.scan(S.ScanSpec(read_ht=max_ht + 10, aggregates=[
                    S.AggSpec("count", None)]))
                for name, (S, e, _rs, _side) in sides.items()}

    def write(step, make):
        for _S, e, rs, side in sides.values():
            e.apply(make(side, rs))
        got = scans()
        assert_same(got["tpu"], got["gpu"], step)
        assert_same(got["cpu"], got["gpu"], step, scanned=False)
        return got["gpu"].rows[0][0]

    for _S, e, rs, _side in sides.values():
        e.apply(rs)
        e.flush()
    assert scans()["gpu"].rows[0][0] > 0
    n = write("live memtable", lambda side, rs: [
        side.row_version.RowVersion(rs[3].key, ht=max_ht + 1,
                                    tombstone=True)])
    for _S, e, _rs, _side in sides.values():
        e.flush()
    got = scans()
    assert sides["gpu"][1].stats()["num_runs"] == 2
    assert_same(got["tpu"], got["gpu"], "two runs")
    assert got["gpu"].rows[0][0] == n
    # More dirty keys than half the primary's 256 rows: the row scan.
    m = write("past half the primary", lambda side, rs: [
        side.row_version.RowVersion(
            encode_key(side, sides["cpu"][1].schema, 1000 + i),
            ht=max_ht + 2, liveness=True) for i in range(130)])
    assert sides["gpu"][1]._overlay_cache[3] is None
    assert m == n + 130
    engines = {"gpu": (T, T.make_engine("gpu", ps, {"rows_per_block": R,
                                                     "device": "cpu"}),
                       rows, PORT),
               "tpu": (J, J.make_engine("tpu", js, {"rows_per_block": R}),
                       jrows, JAX),
               "cpu": (J, J.make_engine("cpu", js), jrows, JAX)}
    got = {}
    for name, (S, e, rs, side) in engines.items():
        e.apply(rs + [side.row_version.RowVersion(
            rs[5].key, ht=max_ht + 1, tombstone=True)])
        e.flush()
        got[name] = [e.scan(S.ScanSpec(read_ht=rd, aggregates=[
            S.AggSpec("count", None)])) for rd in (max_ht, max_ht + 1)]
    assert engines["gpu"][1].runs[0].crun.max_group_versions == 2
    for want, g in zip(got["tpu"], got["gpu"]):
        assert_same(want, g, "one deleted key")
    for want, g in zip(got["cpu"], got["gpu"]):
        assert_same(want, g, "one deleted key", scanned=False)
    assert got["gpu"][0].rows[0][0] == got["gpu"][1].rows[0][0] + 1


# -- multi-version runs -----------------------------------------------------

@pytest.fixture(scope="module")
def mv_engines():
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jrows, max_ht = multiversion_rows(JAX, js, seed=12, hot=0.045)
    prows, _ = multiversion_rows(PORT, ps, seed=12, hot=0.045)
    cpu = J.make_engine("cpu", js)
    tpu = J.make_engine("tpu", js, {"rows_per_block": R})
    gpu = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    for eng, rows in ((cpu, jrows), (tpu, jrows), (gpu, prows)):
        eng.apply(rows)
        eng.flush()
    assert gpu.runs[0].crun.max_group_versions > 32
    exps = sorted({r.expire_ht for r in prows if r.has_ttl})
    return {"js": js, "ps": ps, "cpu": cpu, "tpu": tpu, "gpu": gpu,
            "max_ht": max_ht, "expiries": exps}


def mv_cases(e):
    """(label, spec keyword arguments) on the multi-version run."""
    ps, top = e["ps"], e["max_ht"]
    lo_key, hi_key = encode_key(PORT, ps, 20), encode_key(PORT, ps, 90)
    headline = [("count", None), ("sum", "a"), ("min", "a"), ("max", "a"),
                ("sum", "d")]
    ttl = e["expiries"][len(e["expiries"]) // 2]
    return [
        ("headline", dict(read_ht=top + 1, aggregates=headline,
                          predicates=[("d", ">=", -500_000)])),
        ("all_ints_two_preds", dict(read_ht=top // 2, aggregates=headline + [
            ("count", "d"), ("min", "d"), ("max", "d")],
            predicates=[("a", "<", 0), ("d", "!=", 3)])),
        ("floats", dict(read_ht=MAX_HT, aggregates=[
            ("count", None), ("sum", "c"), ("min", "c"), ("max", "c"),
            ("avg", "c"), ("sum", "a")], predicates=[("c", ">=", 0.0)])),
        ("bounded_mid", dict(lower=lo_key, upper=hi_key, read_ht=top // 3,
                             aggregates=headline)),
        ("before_ttl", dict(read_ht=ttl - 1, aggregates=headline)),
        ("at_ttl", dict(read_ht=ttl, aggregates=headline)),
        ("before_all", dict(read_ht=1, aggregates=headline)),
    ]


def test_multi_version_specs_alone_match_cpu_and_tpu(mv_engines):
    e = mv_engines
    for label, kw in mv_cases(e):
        got = e["gpu"].scan(build(T, kw))
        assert_same(e["tpu"].scan(build(J, kw)), got, label)
        assert_same(e["cpu"].scan(build(J, kw)), got, label, scanned=False)


def jax_route(eng, spec) -> str:
    """The JAX ``tpu`` engine's fold route for a single-run aggregate."""
    exact = eng._split_predicates(spec)[0]
    return eng._device_agg_prep(eng.runs[0], spec, exact)[1]


def past_the_bounds(monkeypatch):
    """Every run past the flat fold's bounds, in both packages: the
    signatures K1 does not take go to the windowed fold (K5)."""
    monkeypatch.setattr(flat_fold, "MAX_B", 1)
    monkeypatch.setattr(j_flat_fold, "MAX_B", 1)


def test_multi_version_routes(mv_engines, monkeypatch):
    e = mv_engines
    routes = {label: e["gpu"]._plan_scan(build(T, kw)).route
              for label, kw in mv_cases(e)}
    assert routes.pop("floats") == "mv_flat"
    assert set(routes.values()) == {"mv_kernel"}
    # Past the flat fold's bounds a non-kernel signature takes the
    # windowed fold over the view (the JAX engine its own "full" route),
    # and gives both JAX engines' answer.
    past_the_bounds(monkeypatch)
    label, kw = mv_cases(e)[2]
    assert e["gpu"]._plan_scan(build(T, kw)).route == "mv_full"
    assert jax_route(e["tpu"], build(J, kw)) == "full"
    got = e["gpu"].scan(build(T, kw))
    assert_same(e["tpu"].scan(build(J, kw)), got, label)
    assert_same(e["cpu"].scan(build(J, kw)), got, label, scanned=False)
    assert e["gpu"].stats()["agg_routes"]["mv_full"] >= 1
    # The kernel has no bound.
    assert e["gpu"]._plan_scan(build(T, mv_cases(e)[0][1])).route == \
        "mv_kernel"
    e["gpu"].scan(build(T, mv_cases(e)[0][1]))


def test_multi_version_async_batch_mixed_read_points(mv_engines,
                                                     monkeypatch):
    """One batch at many read points: one resolve per view key, one K1
    call per (view, signature), every spec equal to both JAX engines."""
    e = mv_engines
    cases = mv_cases(e)
    top = e["max_ht"]
    reads = [top // 7 * k for k in range(1, 7)] + [top + 1, MAX_HT]
    cases += [(f"headline_at_{rd}", dict(cases[0][1], read_ht=rd))
              for rd in reads]
    cases += [(f"headline_lo_{lo}", dict(cases[0][1], predicates=[
        ("d", ">=", lo)])) for lo in (-900_000, 0, 400_000)]
    trun = e["gpu"].runs[0]
    keys = {trun.view_key(kw["read_ht"]) for _l, kw in cases}
    resolves, calls = [], []
    resolve, fold = mvcc_resolve.resolve_view, flat_agg.flat_aggregate

    def counted_resolve(run, *args):
        resolves.append(args[:4])
        return resolve(run, *args)

    def counted_fold(plan, table, params):
        calls.append(params.shape[0])
        return fold(plan, table, params)

    monkeypatch.setattr(mvcc_resolve, "resolve_view", counted_resolve)
    monkeypatch.setattr(flat_agg, "flat_aggregate", counted_fold)
    trun.drop_view()
    batch = e["gpu"].scan_batch_async([build(T, kw) for _l, kw in cases])
    got = batch.finish()
    assert len(resolves) == len(keys) < len(cases)
    assert sum(calls) == len(cases) - 1  # all but the float spec
    assert len(calls) < len(cases) - 1
    for (label, kw), g in zip(cases, got):
        assert_same(e["tpu"].scan(build(J, kw)), g, label)
        assert_same(e["cpu"].scan(build(J, kw)), g, label, scanned=False)
    # The run keeps its latest view: a batch at that key resolves nothing.
    resolves.clear()
    last = trun.held_view()[0]
    again = [kw for _l, kw in cases if trun.view_key(kw["read_ht"]) == last]
    e["gpu"].scan_batch([build(T, kw) for kw in again])
    assert resolves == []


def test_a_batch_holds_one_view_of_a_run_at_a_time(mv_engines,
                                                   monkeypatch):
    """A batch at many read points lets each view go before it resolves
    the next, and the run keeps the last one."""
    e = mv_engines
    trun = e["gpu"].runs[0]
    top = e["max_ht"]
    cases = mv_cases(e)
    kws = [dict(cases[0][1], read_ht=top // 7 * k) for k in range(1, 7)]
    kws.append(dict(cases[2][1], read_ht=kws[2]["read_ht"]))  # mv_flat
    held = []
    resolve = mvcc_resolve.resolve_view

    def watched(run, *args):
        assert [ref() for ref in held if ref() is not None] == []
        view = resolve(run, *args)
        held.append(weakref.ref(view["valid"]))
        return view

    monkeypatch.setattr(mvcc_resolve, "resolve_view", watched)
    trun.drop_view()
    got = e["gpu"].scan_batch([build(T, kw) for kw in kws])
    assert len(held) == len({trun.view_key(kw["read_ht"]) for kw in kws}) \
        == 6
    assert held[-1]() is trun.held_view()[1]["valid"]
    for kw, g in zip(kws, got):
        assert_same(e["tpu"].scan(build(J, kw)), g, kw["read_ht"])


def test_ycsb_a_update_phase_matches_the_cpu_engine():
    """``workload.make_update_rows``: its mix, its version cap, and the
    multi-version run it makes served as the JAX ``cpu`` engine serves
    it at read points across the history."""
    from yugabyte_db_tpu_torch import workload

    ps, js = workload.make_schema(), make_schema(JAX, "bench")
    assert [(c.name, c.col_id) for c in ps.columns] == \
        [(c.name, c.col_id) for c in js.columns]
    rows, load_ht = workload.make_rows(ps, 3000, seed=7)
    ups, top = workload.make_update_rows(ps, rows, load_ht, 6000, seed=7)
    assert ups == workload.make_update_rows(ps, rows, load_ht, 6000,
                                            seed=7)[0]
    n = len(ups)
    tombs = {(u.key, u.ht) for u in ups if u.tombstone}
    ties = [u for u in ups if not u.tombstone and (u.key, u.ht) in tombs]
    assert 6000 <= n <= 6000 + len(ties)
    assert 0.01 < len(tombs) / n < 0.03
    assert 0.2 < len(ties) / len(tombs) < 0.5
    assert all(u.write_id == 1 and u.liveness for u in ties)
    single = [u for u in ups if not u.tombstone and u not in ties]
    assert all(len(u.columns) == 1 and not u.liveness for u in single)
    assert 0.02 < sum(u.has_ttl for u in single) / n < 0.04
    nulls = sum(None in u.columns.values() for u in single)
    assert 0.004 < nulls / n < 0.02
    per_key = {}
    for u in ups:
        per_key[u.key] = per_key.get(u.key, 1) + 1
    assert max(per_key.values()) == workload.MAX_VERSIONS

    gpu = T.make_engine("gpu", ps, {"rows_per_block": 512, "device": "cpu"})
    gpu.apply(rows + ups)
    gpu.flush()
    cpu = J.make_engine("cpu", js)
    cpu.apply([JAX.row_version.RowVersion(
        r.key, ht=r.ht, tombstone=r.tombstone, liveness=r.liveness,
        columns=dict(r.columns), expire_ht=r.expire_ht, write_id=r.write_id)
        for r in rows + ups])
    cpu.flush()
    for rd in (load_ht, (load_ht + top) // 2, top + 1):
        for kw in (dict(read_ht=rd, aggregates=[
                ("count", None), ("sum", "a"), ("min", "a"), ("max", "a"),
                ("sum", "d")], predicates=[("d", ">=", -500_000)]),
                dict(read_ht=rd, aggregates=[("count", "c"), ("avg", "c"),
                                             ("max", "c")])):
            assert_same(cpu.scan(build(J, kw)), gpu.scan(build(T, kw)),
                        rd, scanned=False)


def test_device_defaults_to_cuda():
    ps = make_schema(PORT, "pallas")
    if torch.cuda.is_available():
        assert T.make_engine("gpu", ps).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_engine("gpu", ps)
    eng = T.make_engine("gpu", ps, {"device": "cpu"})
    stats = eng.stats()
    # The process-wide residency cache's stats (storage.residency).
    assert {"budget_bytes", "resident_bytes", "pinned_bytes", "hits",
            "misses", "evictions", "demand_upload_bytes"} <= \
        set(stats.pop("residency"))
    assert stats == {"num_runs": 0, "memtable_versions": 0,
                           "run_versions": 0, "flushed_frontier_ht": 0,
                           "device_bytes": 0,
                           "flush_paths": {"device": 0, "host": 0},
                           "compact_paths": {"k11": 0, "twin": 0,
                                             "host": 0},
                           "agg_routes": {r: 0 for r in (
                               "kernel", "flat", "full", "mv_kernel",
                               "mv_flat", "mv_full")},
                           "full_launches": 0, "code_promotions": 0,
                           "plane_encoding": {
                               "setting": "off", "by_encoding": {},
                               "encoded_bytes": 0, "logical_bytes": 0,
                               "sidecar_device_bytes": 0},
                           "breaker": {"state": "closed", "trips": 0},
                           "host_reserves": 0}
