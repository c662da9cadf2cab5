"""The ``gpu`` engine's row path against the JAX package's ``tpu`` and
``cpu`` engines.

The three engines take the same rows of the ``rows`` table (a FLOAT and a
STRING value column beside the bench columns): one flat run, one
multi-version run (``layered_rows``), and several sources (two runs and a
live memtable). Row scans (full, bounded, LIMIT pages walked to the end by
their resume keys, exact-key reads, key-column / IN / string / float
predicates, projections of key columns) and the aggregates the device
folds do not take (through the gather on one run, through the row scan
over several sources) must give the ``tpu`` engine's rows, resume key
and ``rows_scanned``, and the ``cpu`` engine's rows and resume key.
Both packages upload plain planes ("off"); the range scans and the
LIMIT pages run again with both under their default "auto" (encoded
runs: K7 and K9 read K10's side-car; over several sources, the row scan
and K9), each JAX run touched once by a COUNT(*) first (the JAX engine
builds a run's dictionaries at its first device access).

Also: each route is the JAX engine's (host page, gather, exact-key read,
row scan), and a batch of pages goes to K7 as one launch a (signature,
run) a round.
"""

import pytest

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from test_torch_data import (FLOATS, JAX, MAX_HT, PORT, encode_key,
                             flat_rows, layered_rows, make_schema,
                             plane_encoding)
from yugabyte_db_tpu_torch.ops import row_gather

R = 64
N_KEYS = 800


@pytest.fixture(scope="module", autouse=True)
def _plain_planes():
    with plane_encoding("off"):
        yield


def make_engines(kind: str) -> dict:
    """The three engines of the ``rows`` table: "flat" (one flat run),
    "mv" (one multi-version run) or "sources" (three layers: two runs and
    the last layer live in the memtable)."""
    js, ps = make_schema(JAX, "rows"), make_schema(PORT, "rows")
    if kind == "flat":
        layers = [flat_rows(side, s, N_KEYS, seed=21)
                  for side, s in ((JAX, js), (PORT, ps))]
    else:
        layers = [layered_rows(side, s, (N_KEYS, 500, 300), seed=31)
                  for side, s in ((JAX, js), (PORT, ps))]
    (jrows, ht), (prows, _) = layers
    e = {"cpu": J.make_engine("cpu", js),
         "tpu": J.make_engine("tpu", js, {"rows_per_block": R}),
         "gpu": T.make_engine("gpu", ps, {"rows_per_block": R,
                                          "device": "cpu"}),
         "ps": ps, "ht": ht, "kind": kind}
    for name, rows in (("cpu", jrows), ("tpu", jrows), ("gpu", prows)):
        eng = e[name]
        if kind == "sources":  # each layer its own source
            cut = [0, N_KEYS, N_KEYS + 500, len(rows)]
            for i in range(3):
                eng.apply(rows[cut[i]:cut[i + 1]])
                if i < 2:
                    eng.flush()
        else:
            eng.apply(rows)
            eng.flush()
    # Every JAX run's first device access (see above).
    e["tpu"].scan(J.ScanSpec(read_ht=ht + 1,
                             aggregates=[J.AggSpec("count", None)]))
    return e


@pytest.fixture(scope="module", params=["flat", "mv", "sources"])
def eng_auto(request):
    """``eng``'s engines with both packages under "auto" (encoded runs)."""
    with plane_encoding("auto"):
        e = make_engines(request.param)
    assert all(run.dev.encoded for run in e["gpu"].runs)
    return e


@pytest.fixture
def auto(eng_auto):
    """``eng_auto`` with "auto" set for the test (the JAX engine reads
    the flag at its runs' device accesses)."""
    with plane_encoding("auto"):
        yield eng_auto


@pytest.fixture(scope="module", params=["flat", "mv", "sources"])
def eng(request):
    e = make_engines(request.param)
    runs = e["gpu"].runs
    assert len(runs) == (2 if request.param == "sources" else 1)
    assert runs[0].flat == (request.param != "mv")
    assert e["gpu"].memtable.is_empty == (request.param != "sources")
    return e


def spec(S, kw):
    kw = dict(kw)
    kw["predicates"] = [S.Predicate(*p) for p in kw.get("predicates", [])]
    if kw.get("aggregates"):
        kw["aggregates"] = [S.AggSpec(*a) for a in kw["aggregates"]]
    return S.ScanSpec(**kw)


def check(e, kw, label):
    """The spec on all three engines: the ``tpu`` engine's rows, resume key
    and ``rows_scanned``, the ``cpu`` engine's rows and resume key."""
    got = e["gpu"].scan(spec(T, kw))
    want = e["tpu"].scan(spec(J, kw))
    assert (got.columns, got.rows, got.resume_key, got.rows_scanned) == \
        (want.columns, want.rows, want.resume_key, want.rows_scanned), label
    c = e["cpu"].scan(spec(J, kw))
    assert (got.columns, got.rows, got.resume_key) == \
        (c.columns, c.rows, c.resume_key), label
    return got


def key(e, i):
    return encode_key(PORT, e["ps"], i)


def full_and_bounded_scans(e):
    ht = e["ht"]
    lo, hi = key(e, 120), key(e, 610)
    if lo > hi:
        lo, hi = hi, lo
    for label, kw in [
        ("full", dict(read_ht=ht + 1)),
        ("mid_history", dict(read_ht=ht // 2)),
        ("early", dict(read_ht=ht // 5)),
        ("bounded", dict(read_ht=ht + 1, lower=lo, upper=hi)),
        ("bounded_projection", dict(read_ht=ht // 3, lower=lo, upper=hi,
                                    projection=["d", "k", "f", "r"])),
        ("past_the_end", dict(read_ht=ht + 1, lower=b"\xff\xff")),
    ]:
        got = check(e, kw, label)
        assert label == "past_the_end" or got.rows


def test_full_and_bounded_scans(eng):
    full_and_bounded_scans(eng)


def test_full_and_bounded_scans_encoded(auto):
    full_and_bounded_scans(auto)


PAGES = [
    ("plain", dict(limit=7)),
    ("exact_preds", dict(limit=40, projection=["k", "r", "a", "d"],
                         predicates=[("d", ">=", -300_000),
                                     ("c", "<", 70.0)])),
    ("superset_preds", dict(limit=25, projection=["k", "b", "f"],
                            predicates=[("b", "!=", "zz"),
                                        ("f", "<", 7.75)])),
    ("key_column", dict(limit=30, projection=["r", "k"],
                        predicates=[("r", ">=", 3)])),
    ("wide_page", dict(limit=300)),
]


@pytest.mark.parametrize("label,kw", PAGES, ids=[p[0] for p in PAGES])
def test_limit_pages_walked_by_resume_key(eng, label, kw):
    walk_pages(eng, label, kw)


@pytest.mark.parametrize("label,kw", PAGES, ids=[p[0] for p in PAGES])
def test_limit_pages_walked_by_resume_key_encoded(auto, label, kw):
    walk_pages(auto, label, kw)


def walk_pages(e, label, kw):
    """``tests/test_engine_diff.py::test_diff_paging``'s walk: each page
    resumes at the previous page's resume key until there is none."""
    kw = dict(kw, read_ht=e["ht"] + 1)
    pages = 0
    while True:
        got = check(e, kw, (label, pages))
        pages += 1
        if got.resume_key is None:
            break
        kw = dict(kw, lower=got.resume_key)
    assert pages > 1


PREDS = [
    ("key_and_in", [("r", ">=", 3), ("d", "IN", (0, 1, 2, 3))]),
    ("in_only", [("a", "IN", (5, 6))]),
    ("str_eq_tie", [("b", "=", "commonprefix-ab")]),
    ("str_range", [("b", ">=", "xyz")]),
    ("str_lt", [("b", "<", "xz")]),
    ("f32_eq_tie", [("f", "=", 16777217.0)]),
    ("f32_ne", [("f", "!=", 0.5)]),
    ("f32_ge_zero", [("f", ">=", -0.0)]),
    ("f32_le", [("f", "<=", float(FLOATS[7]))]),
    ("mixed", [("d", "<", 500_000), ("b", "!=", "xy"), ("f", ">", 0.0),
               ("k", ">=", "u00100")]),
]


@pytest.mark.parametrize("label,preds", PREDS, ids=[p[0] for p in PREDS])
def test_predicates(eng, label, preds):
    """Host-only (key column, IN) and superset (str, f32) predicates:
    verified on the decoded rows (one run) or merged rows (several
    sources)."""
    e = eng
    check(e, dict(read_ht=e["ht"] + 1, predicates=preds), label)
    check(e, dict(read_ht=e["ht"] // 2, predicates=preds,
                  projection=["k", "f", "b"], limit=45), label + "_page")


def test_exact_key_reads(eng):
    e, ht = eng, eng["ht"]
    for i in (0, 7, 333, N_KEYS - 1, N_KEYS + 5):  # the last one is absent
        k = key(e, i)
        for kw in (dict(lower=k, upper=k + b"\xff", read_ht=ht + 1),
                   dict(lower=k, upper=k + b"\xff", read_ht=ht // 2,
                        predicates=[("d", ">=", 0)], limit=1),
                   dict(lower=k, upper=k + b"\xff", read_ht=ht + 1,
                        predicates=[("b", "=", "xy")], projection=["k"])):
            check(e, kw, (i, kw.get("limit")))


AGGS = [
    ("str_min_max", dict(aggregates=[("min", "b"), ("max", "b"),
                                     ("count", "b")])),
    ("key_columns", dict(aggregates=[("max", "r"), ("min", "k"),
                                     ("count", None)])),
    ("f32_pred", dict(aggregates=[("count", None), ("sum", "a"),
                                  ("min", "d")],
                      predicates=[("f", ">", 1.0)])),
    ("str_pred_avg", dict(aggregates=[("avg", "d"), ("count", "f")],
                          predicates=[("b", "<=", "xyz")])),
    ("float_sums", dict(aggregates=[("sum", "f"), ("max", "f"),
                                    ("min", "f")],
                        predicates=[("b", "!=", "zz")])),
    ("group_by_key", dict(aggregates=[("count", None), ("sum", "d")],
                          group_by=["r"])),
    ("group_by_f32", dict(aggregates=[("count", None), ("max", "a")],
                          group_by=["f"])),
    ("group_min", dict(aggregates=[("min", "a"), ("count", None)],
                       group_by=["b"], predicates=[("d", ">=", 0)])),
]


@pytest.mark.parametrize("label,kw", AGGS, ids=[a[0] for a in AGGS])
def test_aggregates_on_the_row_path(eng, label, kw):
    """Aggregates the device folds do not take: the gather feeds the
    ``Aggregator`` on one run, the row scan over several sources."""
    e = eng
    for read in (e["ht"] + 1, e["ht"] // 2):
        check(e, dict(kw, read_ht=read), (label, read))


def test_routes(eng):
    """Each spec takes the JAX engine's route."""
    e = eng
    gpu, ht = e["gpu"], e["ht"]
    k = key(e, 5)

    def route(**kw):
        plan = gpu._plan_scan(spec(T, dict(kw, read_ht=ht + 1)))
        return plan[0] if isinstance(plan, tuple) else type(plan).__name__

    several = e["kind"] == "sources"
    assert route(lower=k, upper=k + b"\xff") == "host"
    assert route(limit=10, predicates=[("d", ">", 0)]) == (
        "host" if several else "page" if e["kind"] == "flat" else "gather")
    assert route(limit=10, predicates=[("b", "=", "xy")]) == (
        "host" if several else "gather")
    assert route() == ("host" if several else "gather")
    assert route(aggregates=[("min", "b")]) == (
        "host" if several else "gather")


def test_batch_of_pages_is_one_launch_a_round(eng, monkeypatch):
    """Many pages of one shape in one batch: one K7 call a (signature,
    run) a round, every page equal to the ``tpu`` engine's batch."""
    e = eng
    if e["kind"] == "sources":
        return  # several sources take the row scan: no K7
    calls = []
    wrapper = row_gather.gather_rows

    def counted(sig, run, iparams, fparams):
        calls.append((sig.M, iparams.shape[0]))
        return wrapper(sig, run, iparams, fparams)

    monkeypatch.setattr(row_gather, "gather_rows", counted)
    ht = e["ht"]
    kws = [dict(lower=key(e, 17 * i), read_ht=ht + 1 - (i % 3),
                predicates=[("f", "<", 7.75)], projection=["k", "r", "f"],
                limit=10) for i in range(24)]
    kws += [dict(read_ht=ht + 1)]  # chunks: one params row a window
    got = e["gpu"].scan_batch([spec(T, kw) for kw in kws])
    want = e["tpu"].scan_batch([spec(J, kw) for kw in kws])
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.rows, g.resume_key, g.rows_scanned) == \
            (w.rows, w.resume_key, w.rows_scanned), i
    # Round 1: the 24 pages in one launch, the windows of the full scan in
    # another; later rounds only for pages whose buffer overflowed.
    assert calls[0] == (4096, 24)
    assert calls[1][0] == 8 * R
    assert all(m == 4096 and g <= 24 for m, g in calls[2:])
