"""The port's multi-version fold against the JAX package's K4 and K3.

The port folds a multi-version run as its engine does: the resolved flat
view (``mvcc_resolve.resolve_view_plain``, built from
``ops.seg_fold.resolve_groups``) folded by ``flat_fold`` under the flat
signature. Held against the JAX package's ``seg_fold.
compiled_seg_aggregate`` (segmented associative scans) on the same plane
bytes (the JAX package's unencoded ``DeviceRun.arrays``) of a
multi-version history (``multiversion_rows``: overwrites, one-column
updates, tombstones with same-hybrid-time writes on both sides of them,
TTLs, NULLs; one key past 32 versions), at read points 1, ht/4, ht/2, ht
and MAX_HT: ``ivec`` equal exactly, ``fvec`` (f32 sums, taken in another
order) within rel 1e-5 / abs 1e-3, the tolerance of
``tests/test_seg_fold.py``. On a history within 8 versions a key, the
finalized values also equal the JAX package's ``lookback_fold`` (K3),
whose digit vectors carry the same totals in another distribution.
"""

import numpy as np
import pytest

from test_torch_data import (JAX, MAX_HT, PORT, build_run, make_schema,
                             multiversion_rows, read_planes,
                             reference_planes)
from yugabyte_db_tpu.ops import agg_fold as j_agg_fold
from yugabyte_db_tpu.ops import lookback_fold as j_lookback_fold
from yugabyte_db_tpu.ops import scan as j_scan
from yugabyte_db_tpu.ops import seg_fold as j_seg_fold
from yugabyte_db_tpu_torch.ops import agg_fold, flat_fold, mvcc_resolve
from yugabyte_db_tpu_torch.ops import scan as t_scan
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun, dtype_kind
from yugabyte_db_tpu_torch.utils import planes as P

R = 64
K = 8


def make_run(**rows_kw):
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    rows, max_ht = multiversion_rows(JAX, js, **rows_kw)
    crun = build_run(JAX, js, rows, R)
    planes = reference_planes(crun, K)
    return {"crun": crun, "planes": planes, "max_ht": max_ht,
            "cid": {c.name: c.col_id for c in ps.value_columns},
            "kinds": {c.col_id: dtype_kind(c.dtype)
                      for c in ps.value_columns},
            "jax_arrays": jax_arrays(planes),
            "port": DeviceRun.from_reference_planes(planes, R, "cpu")}


def jax_arrays(planes):
    import jax.numpy as jnp

    return {k: ({c: {n: jnp.asarray(a) for n, a in e.items()}
                 for c, e in v.items()} if k == "cols" else jnp.asarray(v))
            for k, v in planes.items()}


@pytest.fixture(scope="module")
def run():
    r = make_run(seed=4, hot=0.045)
    assert r["crun"].max_group_versions > j_lookback_fold.MAX_LOOKBACK
    return r


@pytest.fixture(scope="module")
def short_run():
    r = make_run(n=300, nkeys=150, seed=6)
    assert 1 < r["crun"].max_group_versions <= 8
    return r


def aggs_of(cid):
    a, c, d = cid["a"], cid["c"], cid["d"]
    return [("count", None, None), ("count", d, "i32"), ("sum", a, "i64"),
            ("sum", d, "i32"), ("min", a, "i64"), ("max", a, "i64"),
            ("min", d, "i32"), ("max", d, "i32"), ("sum", c, "f64"),
            ("min", c, "f64"), ("max", c, "f64")]


def sig_of(scan, run, preds, flat=False, lookback=0):
    return scan.ScanSig(
        B=run["planes"]["valid"].shape[0], R=R, K=K,
        cols=tuple(scan.ColSig(cid, kind)
                   for cid, kind in run["kinds"].items()),
        preds=tuple(scan.PredSig(*p) for p in preds),
        aggs=tuple(scan.AggSig(*a) for a in aggs_of(run["cid"])),
        apply_preds=True, flat=flat, lookback=lookback)


def preds_of(run):
    """An i32, an i64 and an f64 predicate with host literals."""
    cid = run["cid"]
    preds = [(cid["d"], "i32", ">="), (cid["a"], "i64", "<"),
             (cid["c"], "f64", ">=")]
    lits = (agg_fold.pred_literal_host("i32", -400_000),
            agg_fold.pred_literal_host("i64", 5 * 10**11),
            agg_fold.pred_literal_host("f64", -5e5))
    return preds, lits


def port_fold(run, preds, read_ht, args):
    """The port's (ivec, fvec): the run's resolved view at ``read_ht``,
    folded by ``flat_fold`` under the flat signature."""
    port = run["port"]
    view = mvcc_resolve.resolve_view_plain(
        port.arrays, *read_planes(P, read_ht),
        mvcc_resolve.constant_planes(port.B, R, "cpu"))
    sig = sig_of(t_scan, run, preds, flat=True)
    return flat_fold.compiled_flat_aggregate(sig)(view, *args)


def fold_pair(run, jax_fold, jax_sig, preds, lits, read_ht, lo=0, hi=None):
    """((JAX ivec, fvec), (port ivec, fvec)) of one signature."""
    hi = run["crun"].total_rows() if hi is None else hi
    args = (lo, hi, *read_planes(P, read_ht), tuple(lits))
    j = jax_fold(jax_sig)(run["jax_arrays"], *args)
    t = port_fold(run, preds, read_ht, args)
    return ((np.asarray(j[0]), np.asarray(j[1])),
            (np.asarray(t[0]), np.asarray(t[1])))


READS = ["1", "ht/4", "ht/2", "ht", "MAX_HT"]


def read_point(run, which: str) -> int:
    ht = run["max_ht"]
    return {"1": 1, "ht/4": ht // 4, "ht/2": ht // 2, "ht": ht,
            "MAX_HT": MAX_HT}[which]


@pytest.mark.parametrize("case", ["full", "predicates", "row_range"])
@pytest.mark.parametrize("read", READS)
def test_ivec_matches_jax_seg_fold(run, read, case):
    preds, lits = preds_of(run) if case == "predicates" else ([], ())
    total = run["crun"].total_rows()
    lo, hi = (total // 5, total // 2 + 7) if case == "row_range" \
        else (0, total)
    (ji, jf), (ti, tf) = fold_pair(
        run, j_seg_fold.compiled_seg_aggregate, sig_of(j_scan, run, preds),
        preds, lits, read_point(run, read), lo, hi)
    assert ji.dtype == ti.dtype == np.int32
    assert np.array_equal(ji, ti)
    assert jf.shape == tf.shape
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-3)
    if read != "1":
        assert ti[0] > 0


def finalized(agg_fold_mod, aggs, ivec, fvec):
    acc, scanned = agg_fold_mod.unpack(aggs, ivec, fvec)
    return scanned, [agg_fold_mod.finalize(ag, a, ag.fn)
                     for ag, a in zip(aggs, acc)]


@pytest.mark.parametrize("read", ["ht/2", "ht", "MAX_HT"])
def test_finalized_values_match_jax_lookback_fold(short_run, read):
    run = short_run
    W = 1 << (run["crun"].max_group_versions - 1).bit_length()
    jsig = sig_of(j_scan, run, [], lookback=W)
    assert j_lookback_fold.supports(jsig)
    (ji, jf), (ti, tf) = fold_pair(
        run, j_lookback_fold.compiled_lookback_aggregate, jsig, [], (),
        read_point(run, read))
    j_scanned, want = finalized(j_agg_fold, jsig.aggs, ji, jf)
    t_scanned, got = finalized(agg_fold, sig_of(t_scan, run, []).aggs, ti,
                               tf)
    assert t_scanned == j_scanned > 0
    for ag, w, g in zip(jsig.aggs, want, got):
        if ag.fn == "sum" and ag.kind == "f64":
            assert g == pytest.approx(w, rel=1e-5, abs=1e-3)
        else:
            assert g == w, ag
