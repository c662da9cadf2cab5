"""The port's ``gpu`` engine against the JAX package's ``cpu`` and ``tpu``.

``make_engine("gpu", ..., {"device": "cpu"})`` (kernels in their plain
PyTorch versions) and the JAX package's two engines take the same rows.
Every flat-run aggregate spec, alone and in one ``scan_batch_async``
batch, must give the same column names and rows as both (integers, counts,
MIN and MAX exactly; float sums and averages within rel 1e-4 / abs 1e-4,
the tolerance of ``tests/test_engine_diff.py``) and the ``rows_scanned``
the ``tpu`` engine reports (the ``cpu`` engine counts keys examined, a
different statistic). Specs outside the port's slice must raise
``NotImplementedError``.
"""

import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from yugabyte_db_tpu_torch.ops import flat_agg
from test_torch_data import JAX, PORT, encode_key, flat_rows, make_schema

R = 64
N_KEYS = 800


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


def build(S, kwargs):
    kw = dict(kwargs)
    kw["aggregates"] = [S.AggSpec(fn, col) for fn, col in kw["aggregates"]]
    kw["predicates"] = [S.Predicate(*p) for p in kw.get("predicates", [])]
    return S.ScanSpec(**kw)


APPROX = ("sum(c)", "avg(c)", "avg(a)", "avg(d)")


def assert_same(want, got, label, scanned=True):
    assert got.columns == want.columns, label
    assert len(got.rows) == len(want.rows) == 1, label
    for name, w, g in zip(want.columns, want.rows[0], got.rows[0]):
        if name in APPROX and w is not None:
            assert g == pytest.approx(w, rel=1e-4, abs=1e-4), (label, name)
        else:
            assert g == w, (label, name)
    if scanned:
        assert got.rows_scanned == want.rows_scanned, label


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


def test_out_of_slice_specs_raise(engines):
    e = engines
    gpu, top = e["gpu"], e["max_ht"] + 1
    count = [T.AggSpec("count", None)]
    for spec in [
        T.ScanSpec(read_ht=top),                                 # row scan
        T.ScanSpec(read_ht=top, limit=5),
        T.ScanSpec(read_ht=top, aggregates=count, group_by=["b"]),
        T.ScanSpec(read_ht=top, aggregates=[
            T.AggSpec("sum", None, expr=("mul", "a", "d"))]),
        T.ScanSpec(read_ht=top, aggregates=count,
                   predicates=[T.Predicate("b", "=", "xy")]),
        T.ScanSpec(read_ht=top, aggregates=count,
                   predicates=[T.Predicate("d", "IN", (1, 2))]),
        T.ScanSpec(read_ht=top, aggregates=count,
                   predicates=[T.Predicate("r", ">=", 3)]),
        T.ScanSpec(read_ht=top, aggregates=[T.AggSpec("min", "b")]),
        T.ScanSpec(read_ht=top, aggregates=[T.AggSpec("max", "r")]),
    ]:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            gpu.scan(spec)


def test_multi_source_and_multi_version_runs_raise():
    ps = make_schema(PORT, "mixed")
    rows, max_ht = flat_rows(PORT, ps, 200, seed=5)
    spec = T.ScanSpec(read_ht=max_ht + 10,
                      aggregates=[T.AggSpec("count", None)])
    eng = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    eng.apply(rows)
    eng.flush()
    assert eng.scan(spec).rows[0][0] > 0
    eng.apply([PORT.row_version.RowVersion(rows[3].key, ht=max_ht + 1,
                                           tombstone=True)])
    with pytest.raises(NotImplementedError, match="overlay"):
        eng.scan(spec)                                # live memtable
    eng.flush()
    with pytest.raises(NotImplementedError, match="overlay"):
        eng.scan(spec)                                # two runs
    assert eng.stats()["num_runs"] == 2
    mv = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    mv.apply(rows + [PORT.row_version.RowVersion(
        rows[5].key, ht=max_ht + 1, tombstone=True)])
    mv.flush()
    with pytest.raises(NotImplementedError, match="multi-version"):
        mv.scan(spec)


def test_device_defaults_to_cuda():
    ps = make_schema(PORT, "pallas")
    if torch.cuda.is_available():
        assert T.make_engine("gpu", ps).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_engine("gpu", ps)
    eng = T.make_engine("gpu", ps, {"device": "cpu"})
    assert eng.stats() == {"num_runs": 0, "memtable_versions": 0,
                           "run_versions": 0, "flushed_frontier_ht": 0,
                           "device_bytes": 0}
