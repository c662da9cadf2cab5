"""The plain-PyTorch flat fold (K2) against the JAX package's XLA program.

``ops.flat_fold.compiled_flat_aggregate`` of both packages on the same
plane bytes (the JAX package's unencoded ``DeviceRun.arrays``) and the same
scalars: ``ivec`` (counts, exact-sum digits, order-plane extremes) must be
equal, ``fvec`` (f32 sums over the ``arith`` plane, taken in another
order) within rel 1e-4 / abs 1e-4, the tolerance of
``tests/test_engine_diff.py``.
"""

import numpy as np
import pytest

from test_torch_data import (JAX, PORT, build_run, flat_rows, make_schema,
                             read_planes, reference_planes)
from yugabyte_db_tpu.ops import agg_fold as j_agg_fold
from yugabyte_db_tpu.ops import flat_fold as j_flat_fold
from yugabyte_db_tpu.ops import scan as j_scan
from yugabyte_db_tpu_torch.ops import agg_fold, flat_fold
from yugabyte_db_tpu_torch.ops import scan as t_scan
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun, dtype_kind
from yugabyte_db_tpu_torch.utils import planes as P

R = 64
N_KEYS = 1200
K = 8


@pytest.fixture(scope="module")
def run():
    js, ps = make_schema(JAX, "mixed"), make_schema(PORT, "mixed")
    rows, max_ht = flat_rows(JAX, js, N_KEYS, seed=33)
    crun = build_run(JAX, js, rows, R)
    planes = reference_planes(crun, K)
    return {"crun": crun, "planes": planes, "max_ht": max_ht,
            "cid": {c.name: c.col_id for c in ps.value_columns},
            "kinds": {c.col_id: dtype_kind(c.dtype)
                      for c in ps.value_columns},
            "port": DeviceRun.from_reference_planes(planes, R, "cpu")}


def fold_both(run, aggs, preds, lits, lo=0, hi=None, read_ht=None):
    """(JAX ivec, fvec), (port ivec, fvec) of one signature."""
    import jax.numpy as jnp

    hi = run["crun"].total_rows() if hi is None else hi
    read_ht = run["max_ht"] + 1 if read_ht is None else read_ht
    B = run["planes"]["valid"].shape[0]
    out = []
    for scan, fold, arrays in (
            (j_scan, j_flat_fold,
             {k: ({c: {n: jnp.asarray(a) for n, a in e.items()}
                   for c, e in v.items()} if k == "cols"
                  else jnp.asarray(v))
              for k, v in run["planes"].items()}),
            (t_scan, flat_fold, run["port"].arrays)):
        sig = scan.ScanSig(
            B=B, R=R, K=K,
            cols=tuple(scan.ColSig(cid, kind)
                       for cid, kind in run["kinds"].items()),
            preds=tuple(scan.PredSig(*p) for p in preds),
            aggs=tuple(scan.AggSig(*a) for a in aggs), apply_preds=True,
            flat=True)
        assert fold.supports(sig)
        ivec, fvec = fold.compiled_flat_aggregate(sig)(
            arrays, lo, hi, *read_planes(P, read_ht), tuple(lits))
        out.append((np.asarray(ivec), np.asarray(fvec)))
    return out


def assert_close(run, aggs, preds, lits, **kw):
    (ji, jf), (ti, tf) = fold_both(run, aggs, preds, lits, **kw)
    assert ji.dtype == ti.dtype == np.int32
    assert np.array_equal(ji, ti)
    assert jf.shape == tf.shape
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)
    return ti, tf


def agg_set(cid):
    a, b, c, d = cid["a"], cid["b"], cid["c"], cid["d"]
    return [("count", None, None), ("count", b, "str"), ("sum", c, "f64"),
            ("min", c, "f64"), ("max", c, "f64"), ("sum", a, "i64"),
            ("sum", d, "i32"), ("min", d, "i32"), ("max", a, "i64")]


@pytest.mark.parametrize("op", ["=", "!=", "<", "<=", ">", ">="])
def test_f64_predicates_match_jax(run, op):
    cid = run["cid"]
    crun = run["crun"]
    col = crun.cols[cid["c"]]
    keep = (col.set_ & ~col.isnull).reshape(-1)
    pick = crun.cols[cid["c"]].cmp_planes.reshape(-1, 2)[
        np.flatnonzero(keep)[50]]
    ivec, _ = assert_close(run, agg_set(cid), [(cid["c"], "f64", op)],
                           [pick.astype(np.int32)])
    assert ivec[0] > 0


@pytest.mark.parametrize("case", ["mid_history", "bounded", "int_preds"])
def test_int_sums_and_bounds_match_jax(run, case):
    cid = run["cid"]
    total = run["crun"].total_rows()
    preds, lits, kw = [], [], {}
    if case == "mid_history":
        kw["read_ht"] = (100 + run["max_ht"]) // 2
    elif case == "bounded":
        kw.update(lo=total // 5, hi=total // 2 + 11)
    else:
        preds = [(cid["d"], "i32", ">="), (cid["a"], "i64", "<")]
        lits = [agg_fold.pred_literal_host("i32", -300_000),
                agg_fold.pred_literal_host("i64", 5 * 10**13)]
        assert np.array_equal(lits[1],
                              j_agg_fold.pred_literal_host("i64", 5 * 10**13))
    ivec, fvec = assert_close(run, agg_set(cid), preds, lits, **kw)
    assert ivec[0] > 0 and fvec.shape == (2,)  # sum(c): fsum, fcomp


def test_unpack_finalize_match_jax(run):
    """The packed vectors finish to the same Python values on both
    sides' agg_fold (exact ints; floats within the fold tolerance)."""
    cid = run["cid"]
    aggs = agg_set(cid)
    (ji, jf), (ti, tf) = fold_both(run, aggs, [], [])
    jaggs = tuple(j_scan.AggSig(*a) for a in aggs)
    taggs = tuple(t_scan.AggSig(*a) for a in aggs)
    jacc, jscanned = j_agg_fold.unpack(jaggs, ji, jf)
    tacc, tscanned = agg_fold.unpack(taggs, ti, tf)
    assert jscanned == tscanned
    for ja, ta, jv, tv in zip(jaggs, taggs, jacc, tacc):
        want = j_agg_fold.finalize(ja, jv, ja.fn)
        got = agg_fold.finalize(ta, tv, ta.fn)
        if ja.fn == "sum" and ja.kind == "f64":
            assert got == pytest.approx(want, rel=1e-4, abs=1e-4)
        else:
            assert got == want
