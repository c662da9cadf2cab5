"""The ``gpu`` engine (CPU tensors, plain versions) with its default
``plane_encoding`` "auto" against the JAX ``tpu`` and ``cpu`` engines
under the JAX package's default ``tpu_plane_encoding`` "auto": the same
rows exactly (float sums within ``tests/test_engine_diff.py``'s
tolerance), and the ``tpu`` engine's ``rows_scanned``.

Covered: a compacted run (flat and multi-version), a flushed run with
string value columns (dictionary codes written by the flush), string
predicates promoted to code compares, the delta overlay on a run whose
``valid`` is bit-packed (K13b), TPC-H Q1 and Q6 at 20,000 rows with and
without promoted predicates, and ``"off"`` against ``"auto"``.

Both engines build a host-built run's dictionaries at the run's first
device access (their residency caches upload on demand), so a first
string aggregate over a fresh run is not promoted. Each run is touched
once by a COUNT(*) before the comparisons, so that both engines serve
the same routes.
"""

import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from test_torch_data import (JAX, PORT, assert_same, assert_same_rows,
                             build_spec, flat_rows, jax_rows, layered_rows,
                             make_schema)
from yugabyte_db_tpu.yql.pgsql import tpch
from yugabyte_db_tpu_torch import workload as W
from yugabyte_db_tpu_torch.ops import encodings as enc

R = 64


def engines(table: str, encoding: str = "auto"):
    ps, js = make_schema(PORT, table), make_schema(JAX, table)
    return {"gpu": T.make_engine("gpu", ps, {"rows_per_block": R,
                                              "device": "cpu",
                                              "plane_encoding": encoding}),
            "tpu": J.make_engine("tpu", js, {"rows_per_block": R}),
            "cpu": J.make_engine("cpu", js)}


def apply(e, rows):
    for name, eng in e.items():
        eng.apply(rows if name == "gpu" else jax_rows(rows))


def each(e, fn):
    for eng in e.values():
        fn(eng)


def touch(e, read_ht):
    """Every run's first device access on both engines (see above)."""
    e["tpu"].scan(J.ScanSpec(read_ht=read_ht,
                             aggregates=[J.AggSpec("count", None)]))
    e["gpu"].scan(T.ScanSpec(read_ht=read_ht,
                             aggregates=[T.AggSpec("count", None)]))


def specs(read_ht: int) -> list:
    """Aggregates over every route: K1, the flat fold, K8, the gather and
    string predicates that promote (absent literals too)."""
    return [
        dict(read_ht=read_ht, aggregates=[("count", None), ("sum", "a"),
                                          ("min", "d"), ("max", "d")],
             predicates=[("d", ">=", -500_000)]),
        dict(read_ht=read_ht, aggregates=[("sum", "c"), ("max", "c")]),
        dict(read_ht=read_ht, aggregates=[("count", None), ("sum", "d")],
             predicates=[("b", "=", "xyz")]),
        dict(read_ht=read_ht, aggregates=[("count", "a")],
             predicates=[("b", "<", "xz"), ("d", "<", 0)]),
        dict(read_ht=read_ht, aggregates=[("count", None)],
             predicates=[("b", ">=", "commonprefix-ab")]),
        dict(read_ht=read_ht, aggregates=[("count", None)],
             predicates=[("b", "=", "absent")]),
        dict(read_ht=read_ht, aggregates=[("count", None), ("max", "a")],
             predicates=[("b", "!=", "zz")]),
        dict(read_ht=read_ht, aggregates=[("count", None)],
             predicates=[("b", ">", "zz")]),
        dict(read_ht=read_ht, aggregates=[("count", None), ("sum", "a")],
             group_by=["b"]),
    ]


def check(e, kw, label):
    got = e["gpu"].scan(build_spec(T, kw))
    want = e["tpu"].scan(build_spec(J, kw))
    if kw.get("group_by"):
        assert_same_rows(want, got, label)
    else:
        assert_same(want, got, label)
        assert_same(e["cpu"].scan(build_spec(J, kw)), got, label,
                    scanned=False)
    return got


@pytest.mark.parametrize("shape", ["flat", "mv"])
def test_compacted_run_matches_jax(shape):
    if shape == "flat":
        e = engines("mixed")
        rows, ht = flat_rows(PORT, make_schema(PORT, "mixed"), 900, seed=9)
    else:
        e = engines("mixed")
        rows, ht = layered_rows(PORT, make_schema(PORT, "mixed"))
    apply(e, rows[:len(rows) // 2])
    each(e, lambda eng: eng.flush())
    apply(e, rows[len(rows) // 2:])
    each(e, lambda eng: eng.flush())
    each(e, lambda eng: eng.compact())
    run = e["gpu"].runs[0]
    assert run.dev.encoded and run.flat == (shape == "flat")
    assert enc.leaf_kind(run.dev.arrays["valid"]) == "bits"
    assert enc.leaf_kind(run.dev.arrays["cols"][
        make_schema(PORT, "mixed").column("b").col_id]["cmp"]) == "dict"
    touch(e, ht + 1)
    p0 = e["gpu"].code_promotions
    for read in (ht + 1, ht - 200, ht // 2):
        for i, kw in enumerate(specs(read)):
            check(e, kw, (shape, read, i))
    assert e["gpu"].code_promotions - p0 == 3 * 6
    st = e["gpu"].stats()["plane_encoding"]
    assert st["encoded_bytes"] < st["logical_bytes"]
    assert st["sidecar_device_bytes"] > 0 and "dict" in st["by_encoding"]


def test_flushed_string_columns_are_dictionary_codes():
    e = engines("mixed")
    rows, ht = flat_rows(PORT, make_schema(PORT, "mixed"), 700, seed=4)
    apply(e, rows)
    each(e, lambda eng: eng.flush())
    run = e["gpu"].runs[0]
    assert e["gpu"].stats()["flush_paths"]["device"] == 1
    bcid = make_schema(PORT, "mixed").column("b").col_id
    cmp = run.dev.arrays["cols"][bcid]["cmp"]
    assert enc.leaf_kind(cmp) == "dict" and run.dev.encoded
    # Only the string columns are coded; the rest stays plain.
    assert all(enc.leaf_kind(c["cmp"]) is None
               for cid, c in run.dev.arrays["cols"].items() if cid != bcid)
    assert e["tpu"].runs[0].crun.encoded_arrays() is not None
    assert run.crun.enc_dicts == e["tpu"].runs[0].crun.enc_dicts
    p0 = e["gpu"].code_promotions
    for i, kw in enumerate(specs(ht + 1)):
        check(e, kw, ("flushed", i))
    assert e["gpu"].code_promotions - p0 == 6


def test_promotion_off_keeps_the_gather_and_equal_results():
    """``off`` gives the plain upload and no promotion; its results equal
    ``auto``'s (``rows_scanned`` too where no string predicate changes
    the route)."""
    on, off = engines("mixed"), engines("mixed", "off")
    rows, ht = flat_rows(PORT, make_schema(PORT, "mixed"), 600, seed=6)
    for e in (on, off):
        apply(e, rows)
        each(e, lambda eng: eng.flush())
        each(e, lambda eng: eng.compact())
    assert on["gpu"].runs[0].dev.encoded
    assert not off["gpu"].runs[0].dev.encoded
    for i, kw in enumerate(specs(ht + 1)):
        a = on["gpu"].scan(build_spec(T, kw))
        b = off["gpu"].scan(build_spec(T, kw))
        string_pred = any(p[0] == "b" for p in kw.get("predicates", []))
        if kw.get("group_by"):
            assert_same_rows(b, a, i)
        else:
            assert_same(b, a, i, scanned=not string_pred)
    assert off["gpu"].code_promotions == 0
    assert on["gpu"].code_promotions == 6


def test_overlay_on_a_bit_packed_valid():
    e = engines("mixed")
    rows, ht = flat_rows(PORT, make_schema(PORT, "mixed"), 800, seed=12)
    for half in (rows[:400], rows[400:]):
        apply(e, half)
        each(e, lambda eng: eng.flush())
    each(e, lambda eng: eng.compact())
    assert enc.leaf_kind(e["gpu"].runs[0].dev.arrays["valid"]) == "bits"
    # Later writes to some of the keys: a second run and a live memtable.
    more, ht2 = flat_rows(PORT, make_schema(PORT, "mixed"), 120, seed=13)
    more = [type(r)(r.key, ht=r.ht + ht, tombstone=r.tombstone,
                    liveness=r.liveness, columns=dict(r.columns),
                    expire_ht=(r.expire_ht if r.expire_ht == T.MAX_HT
                               else r.expire_ht + ht))
            for r in more]
    apply(e, more[:60])
    each(e, lambda eng: eng.flush())
    apply(e, more[60:])
    top = ht + ht2 + 1
    touch(e, top)
    for read in (top, ht + 1, ht - 100):
        for i, kw in enumerate(specs(read)[:2]):
            got = check(e, kw, ("overlay", read, i))
            assert got is not None
    ov = e["gpu"]._overlay_cache[3]
    assert ov is not None and ov.masked.dev.arrays["valid"].dtype == \
        torch.bool
    assert int(ov.masked.dev.arrays["valid"].sum()) == int(
        e["gpu"].runs[0].plain()["valid"].sum()) - ov.idx.size


def tpch_engines(halves: int):
    """The three engines on 20,000 lineitem rows: one flushed run
    (``halves`` 1), or two flushed halves compacted into one run."""
    rows, ht = W.lineitem_rows(W.lineitem_schema(),
                               W.generate_lineitem(20_000))
    e = {"tpu": J.make_engine("tpu", tpch.lineitem_schema(),
                              {"rows_per_block": 256}),
         "cpu": J.make_engine("cpu", tpch.lineitem_schema()),
         "gpu": T.make_engine("gpu", W.lineitem_schema(),
                              {"rows_per_block": 256, "device": "cpu"})}
    step = len(rows) // halves
    for k in range(halves):
        apply(e, rows[k * step:(k + 1) * step])
        each(e, lambda eng: eng.flush())
    if halves > 1:
        each(e, lambda eng: eng.compact())
    return e, ht


def q1_promoted(S, W_or_tpch, ht):
    """Q1 with ``l_returnflag >= 'N' and l_linestatus = 'O'``."""
    spec = W_or_tpch.q1_spec(ht + 1)
    spec.predicates = list(spec.predicates) + [
        S.Predicate("l_returnflag", ">=", "N"),
        S.Predicate("l_linestatus", "=", "O")]
    return spec


@pytest.mark.parametrize("stage", ["flushed", "compacted"])
def test_tpch_q1_q6_match_jax(stage):
    e, ht = tpch_engines(1 if stage == "flushed" else 2)
    run = e["gpu"].runs[0]
    assert len(e["gpu"].runs) == 1 and run.dev.encoded
    flag = W.lineitem_schema().column("l_returnflag").col_id
    assert enc.leaf_kind(run.dev.arrays["cols"][flag]["cmp"]) == "dict"
    assert (enc.leaf_kind(run.dev.arrays["valid"]) == "bits") == \
        (stage == "compacted")
    touch(e, ht + 1)
    p0 = e["gpu"].code_promotions
    pairs = [(tpch.q1_spec(ht + 1), W.q1_spec(ht + 1)),
             (tpch.q6_spec(ht + 1), W.q6_spec(ht + 1)),
             (tpch.q6_spec(ht + 1, 8766, 0, 51),
              W.q6_spec(ht + 1, 8766, 0, 51)),
             (q1_promoted(J, tpch, ht), q1_promoted(T, W, ht))]
    for i, (jspec, pspec) in enumerate(pairs):
        got = e["gpu"].scan(pspec)
        assert_same_rows(e["tpu"].scan(jspec), got, (stage, i))
        assert_same_rows(e["cpu"].scan(jspec), got, (stage, i),
                         scanned=False)
    assert e["gpu"].code_promotions - p0 == 1
    assert e["gpu"].grouped_host_folds == 0
    assert [r[:2] for r in e["gpu"].scan(pairs[-1][1]).rows] == [("N", "O")]
