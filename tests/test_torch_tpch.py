"""TPC-H lineitem, Q1 and Q6 on the port against the JAX package.

The port's lineitem (``workload.py``: schema, the numpy generator, the
zipfian updates, the Q1/Q6 specs) against the JAX package's
``yql/pgsql/tpch.py``, and the ``gpu`` engine (``device="cpu"``) against
the JAX ``tpu`` and ``cpu`` engines on the same generated rows: Q1 and
Q6 over a flat run, over key ranges that split it, and over a
multi-version run at two read points. Rows and columns exactly, and the
``tpu`` engine's ``rows_scanned``. The SQL frontend of
``tests/test_tpch.py`` is not ported (ROADMAP.md §1 item 16).
"""

import dataclasses

import numpy as np
import pytest

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from test_torch_data import assert_same_rows, jax_rows, plain_planes
from yugabyte_db_tpu.models.partition import compute_hash_code
from yugabyte_db_tpu.storage import expr as JX
from yugabyte_db_tpu.yql.pgsql import tpch
from yugabyte_db_tpu_torch import workload as W
from yugabyte_db_tpu_torch.storage import expr as TX

N = 6000
R = 256


def load(rows):
    with plain_planes():
        tpu = J.make_engine("tpu", tpch.lineitem_schema(),
                            {"rows_per_block": R})
        cpu = J.make_engine("cpu", tpch.lineitem_schema())
        for eng in (tpu, cpu):
            eng.apply(jax_rows(rows))
            eng.flush()
    gpu = T.make_engine("gpu", W.lineitem_schema(), {"rows_per_block": R,
                                                      "device": "cpu"})
    gpu.apply(rows)
    gpu.flush()
    return {"tpu": tpu, "cpu": cpu, "gpu": gpu}


@pytest.fixture(scope="module")
def engines():
    rows, ht = W.lineitem_rows(W.lineitem_schema(), W.generate_lineitem(N))
    return load(rows), ht


def _both(e, jspec, pspec, label, folds=0):
    f0 = e["gpu"].grouped_host_folds
    got = e["gpu"].scan(pspec)
    assert_same_rows(e["tpu"].scan(jspec), got, label)
    assert_same_rows(e["cpu"].scan(jspec), got, label, scanned=False)
    assert e["gpu"].grouped_host_folds - f0 == folds
    return got


def test_q1_engine_matches_jax(engines):
    e, ht = engines
    got = _both(e, tpch.q1_spec(ht + 1), W.q1_spec(ht + 1), "q1")
    assert [r[:2] for r in got.rows] == [("A", "F"), ("N", "F"), ("N", "O"),
                                         ("R", "F")]
    for r in tpch.q1_result(got):
        assert r["sum_disc_price"] < r["sum_base_price"]
        assert r["sum_charge"] > r["sum_disc_price"]
        assert r["count_order"] > 0


@pytest.mark.parametrize("args", [(), (9131, 6, 24), (8766, 0, 51),
                                  (10900, 10, 2)])
def test_q6_engine_matches_jax(engines, args):
    e, ht = engines
    got = _both(e, tpch.q6_spec(ht + 1, *args), W.q6_spec(ht + 1, *args),
                args)
    if not args:
        assert tpch.q6_result(got) > 0


def test_q1_over_split_ranges_matches_jax(engines):
    """The multi-tablet shape of ``test_q1_partitioned_combine``: the
    halves of a split key range, each against the JAX engines, add up to
    the whole."""
    e, ht = engines
    whole = e["gpu"].scan(W.q1_spec(ht + 1))
    crun = e["gpu"].runs[0].crun
    mid = crun.key_at(crun.total_rows() // 2)
    parts = []
    for lower, upper in ((b"", mid), (mid, b"")):
        jspec = dataclasses.replace(tpch.q1_spec(ht + 1), lower=lower,
                                    upper=upper)
        pspec = dataclasses.replace(W.q1_spec(ht + 1), lower=lower,
                                    upper=upper)
        parts.append(_both(e, jspec, pspec, (lower, upper)))
    combined = {}
    for part in parts:
        for r in part.rows:
            acc = combined.setdefault(r[:2], [0] * (len(r) - 2))
            for i, v in enumerate(r[2:]):
                acc[i] += v
    assert [r[:2] + tuple(combined[r[:2]]) for r in whole.rows] == whole.rows
    assert sum(p.rows_scanned for p in parts) == whole.rows_scanned


def test_multiversion_lineitem_matches_jax():
    schema = W.lineitem_schema()
    cols = W.generate_lineitem(2000, seed=5)
    rows, ht = W.lineitem_rows(schema, cols)
    updates, upd = W.make_lineitem_updates(
        schema, W.lineitem_keys(schema, cols), ht, 3000, seed=6)
    e = load(rows + updates)
    assert not e["gpu"].runs[0].flat
    assert e["gpu"].runs[0].crun.max_group_versions > 32
    newest, mid = int(upd["ht"][-1]) + 1, int(upd["ht"][1500])
    for read in (newest, mid, ht):
        _both(e, tpch.q1_spec(read), W.q1_spec(read), read)
        _both(e, tpch.q6_spec(read), W.q6_spec(read), read)


def test_lineitem_schema_keys_and_specs_match_jax():
    ps, js = W.lineitem_schema(), tpch.lineitem_schema()
    assert [(c.name, c.dtype.name, c.kind.name, c.col_id)
            for c in ps.columns] == [(c.name, c.dtype.name, c.kind.name,
                                      c.col_id) for c in js.columns]
    cols = W.generate_lineitem(500, seed=3)
    keys = W.lineitem_keys(ps, cols)
    for i, key in enumerate(keys):
        kv = {"l_orderkey": int(cols["l_orderkey"][i]),
              "l_linenumber": int(cols["l_linenumber"][i])}
        assert key == js.encode_primary_key(kv, compute_hash_code(
            js, {"l_orderkey": kv["l_orderkey"]}))

    def fields(spec, X):
        def ex(e):
            if e is None:
                return None
            if isinstance(e, X.Col):
                return e.name
            if isinstance(e, X.Const):
                return e.value
            return (e.op, ex(e.left), ex(e.right))

        return (spec.read_ht, spec.group_by,
                [(p.column, p.op, p.value) for p in spec.predicates],
                [(a.fn, a.column, ex(a.expr), a.label)
                 for a in spec.aggregates])

    for args in ((), (10000,)):
        assert fields(W.q1_spec(77, *args), TX) == \
            fields(tpch.q1_spec(77, *args), JX)
    for args in ((), (9000, 3, 11)):
        assert fields(W.q6_spec(77, *args), TX) == \
            fields(tpch.q6_spec(77, *args), JX)


def test_generator_follows_the_reference_distributions():
    n = 40_000
    c = W.generate_lineitem(n, seed=9)
    ref = list(tpch.generate_lineitem(n, seed=9))
    np.testing.assert_array_equal(c["l_orderkey"],
                                  [r["l_orderkey"] for r in ref])
    np.testing.assert_array_equal(c["l_linenumber"],
                                  [r["l_linenumber"] for r in ref])
    for name, lo, hi in (("l_quantity", 1, 50), ("l_discount", 0, 10),
                         ("l_tax", 0, 8),
                         ("l_shipdate", W.SHIPDATE_LO, W.SHIPDATE_HI - 1)):
        vals = np.array([r[name] for r in ref])
        assert c[name].min() == vals.min() == lo, name
        assert c[name].max() == vals.max() == hi, name
        # Uniform draws: the means agree within a few standard errors.
        assert abs(c[name].mean() - vals.mean()) < 5 * vals.std() / n ** 0.5
    unit = c["l_extendedprice"] * 10 // c["l_quantity"]
    assert unit.min() >= 900_00 - 10 and unit.max() < 11_000_00
    early = c["l_shipdate"] < 9496
    assert set(c["l_returnflag"][early]) == {"A", "R"}
    assert set(c["l_returnflag"][~early]) == {"N"}
    assert (c["l_linestatus"] == np.where(
        early | (c["l_shipdate"] <= 9600), "F", "O")).all()
    for flag in "ANR":
        share = (c["l_returnflag"] == flag).mean()
        want = np.mean([r["l_returnflag"] == flag for r in ref])
        assert abs(share - want) < 0.02, flag


def test_zipfian_updates_respect_the_cap():
    rng = np.random.default_rng(4)
    rows = W.zipfian_draws(500, 5_000, 40, rng)
    assert rows.size == 5_000
    counts = np.bincount(rows, minlength=500)
    assert counts.max() == 40
    assert (counts == 40).sum() > 1  # the hot keys reached the cap
    schema = W.lineitem_schema()
    cols = W.generate_lineitem(100, seed=2)
    keys = W.lineitem_keys(schema, cols)
    updates, upd = W.make_lineitem_updates(schema, keys, 100, 300, seed=3)
    assert [u.ht for u in updates] == list(range(101, 401))
    for u, row, f, v in zip(updates, upd["row"], upd["field"], upd["value"]):
        name = W.LINEITEM_UPDATED[f]
        assert u.key == keys[row]
        assert u.columns == {schema.column(name).col_id: v}
        assert not u.liveness and not u.tombstone
