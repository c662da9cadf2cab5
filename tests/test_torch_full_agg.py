"""The windowed full-run aggregate (K5): the port against the JAX program.

Seeded numpy planes (``workload.flat_planes``: integer and float columns,
NULLs, unset values, tombstones, TTLs, invalid rows, values at the
extremes, a never-set and an all-NULL column, 17 value columns in all) go
through the JAX package's ``agg_fold.compiled_full_aggregate(sig)`` on
the CPU (as ``tests/test_seg_fold.py`` calls it) and through the port's
``agg_fold.compiled_full_aggregate(sig)`` on CPU tensors, which runs the
plain version (``full_aggregate_plain``: the arithmetic of
``csrc/full_agg.cu``). Both are the same windowed algorithm, so the ivec
(counts, exact-sum digits after one carry step a window, order-plane
extremes) must be equal digit for digit; finalized floats agree within
rel 1e-5 / abs 1e-3 (``tests/test_seg_fold.py``'s tolerance: the f32
sums are taken in another order, and the data keeps them well
conditioned). The plan, descriptor and launch shape of ``ops.full_agg``
are checked in pure Python, and ``flat_planes`` for its layout and
against the plain flat fold.
"""

import dataclasses

import numpy as np
import pytest
import torch

from yugabyte_db_tpu.ops import agg_fold as j_agg_fold
from yugabyte_db_tpu.ops import scan as j_scan
from yugabyte_db_tpu_torch import workload
from yugabyte_db_tpu_torch.ops import agg_fold, flat_fold, full_agg
from yugabyte_db_tpu_torch.ops import scan as t_scan
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
from yugabyte_db_tpu_torch.utils import planes as P

K = 8
BLOCKS = {8: 64, 48: 32, 64: 40}  # blocks of the planes at each R
# (col_id, kind, P(set), P(NULL | set), P(extreme | not NULL)): 17 value
# columns; 1-2 take integer extremes, 5 and 7 float extremes (MIN/MAX
# only: their arith planes hold +-inf / +-FLT_MAX), 6 is never set, 8 is
# NULL wherever it is set.
COLUMNS = ((1, "i32", 0.97, 0.03, 0.01), (2, "i64", 0.99, 0.02, 0.01),
           (3, "f32", 0.95, 0.05, 0.0), (4, "f64", 0.95, 0.05, 0.0),
           (5, "f64", 0.9, 0.05, 0.02), (6, "i64", 0.0, 0.0, 0.0),
           (7, "f32", 0.9, 0.1, 0.02), (8, "i32", 0.9, 1.0, 0.0),
           *((c, ("i32", "i64", "f32", "f64")[c % 4], 0.9, 0.02, 0.0)
             for c in range(9, 18)))
KIND = {c[0]: c[1] for c in COLUMNS}
OPS = ("=", "!=", "<", "<=", ">", ">=")
_PLANES: dict = {}


def planes_at(R: int) -> dict:
    """The planes at ``R`` on both sides, made once a process."""
    if R not in _PLANES:
        import jax.numpy as jnp

        planes, reads = workload.flat_planes(BLOCKS[R], R, COLUMNS, seed=R)
        _PLANES[R] = {
            "planes": planes, "reads": reads,
            "jax": {k: ({c: {n: jnp.asarray(a) for n, a in e.items()}
                         for c, e in v.items()} if k == "cols"
                        else jnp.asarray(v)) for k, v in planes.items()},
            "port": DeviceRun.from_reference_planes(planes, R, "cpu").arrays}
    return _PLANES[R]


def agg(S, fn, col=None):
    return S.AggSig(fn, col, KIND.get(col))


def read_planes(read_ht: int) -> tuple:
    r = P.scalar_ht_planes(read_ht)
    return (*r, *r)


def lit(kind: str, value):
    """A host literal (``pred_literal_host``'s form)."""
    if kind == "i32":
        return np.int32(value)
    hi, lo = (P.i64_to_ordered_planes(np.array([value], np.int64))
              if kind == "i64"
              else P.f64_to_ordered_planes(np.array([value], np.float64)))
    return np.array([hi[0], lo[0]], np.int32)


# Signatures: (aggregates as (fn, col)), (predicates as (col, op, value)).
SIGNATURES = {
    # 9 aggregates: COUNT(*), COUNT(col), i32 and i64 SUM/MIN/MAX (with
    # the extremes of columns 1 and 2 in them), under an i64 predicate.
    "ints": ([("count", None), ("count", 1), ("sum", 1), ("min", 1),
              ("max", 1), ("sum", 2), ("min", 2), ("max", 2), ("count", 2)],
             [(2, "!=", 0)]),
    # f32 / f64 SUM/MIN/MAX, float extremes, under an f64 range.
    "floats": ([("sum", 3), ("min", 3), ("max", 3), ("sum", 4), ("min", 4),
                ("max", 4), ("min", 5), ("max", 5), ("min", 7), ("max", 7),
                ("count", 4)],
               [(4, ">=", 100.0), (4, "<", 900.0)]),
    # 9 predicates over 9 columns of every kind but f32 (a superset kind:
    # the engine folds those on the host).
    "nine_preds": ([("count", None), ("sum", 12), ("max", 13), ("min", 15),
                    ("sum", 9), ("sum", 10), ("max", 14)],
                   [(1, ">=", -900_000), (2, "<=", 10**12), (4, "!=", 5.0),
                    (9, ">", -10**12), (11, "<", 990.0), (12, ">=", -999_000),
                    (13, "!=", -1), (15, "<=", 999.5), (16, ">", -10**6)]),
    # The all-NULL and the never-set column.
    "null_columns": ([("count", None), ("count", 8), ("sum", 8), ("min", 8),
                      ("max", 8), ("count", 6), ("sum", 6), ("min", 6),
                      ("max", 6)], [(1, "<", 500_000)]),
}


def signature(S, B: int, R: int, aggs, preds):
    return S.ScanSig(
        B=B, R=R, K=K, cols=tuple(S.ColSig(c, KIND[c]) for c in KIND),
        preds=tuple(S.PredSig(c, KIND[c], op) for c, op, _v in preds),
        aggs=tuple(agg(S, fn, c) for fn, c in aggs), apply_preds=True,
        flat=True)


def cases(R: int, reads: dict):
    """(label, row_lo, row_hi, w_first, w_last, read point) of every
    window and range case: whole, a middle window range, an empty window
    range, a row range whose ends lie inside blocks, an empty row range;
    at the newest, a mid and an early read point."""
    B = BLOCKS[R]
    n, W = B * R, B // K

    def bounded(lo, hi):
        return (lo, hi, *agg_fold.window_bounds(lo, hi, R, K, W))

    return [("whole", 0, n, 0, W, reads["all"]),
            ("middle_windows", 0, n, 1, W - 1, reads["mid"]),
            ("empty_windows", 0, n, 2, 2, reads["all"]),
            ("inside_blocks", *bounded(R + 3, n - 2 * R - 5), reads["early"]),
            ("one_window_part", *bounded(K * R + 1, 2 * K * R - 1),
             reads["mid"]),
            ("empty_range", *bounded(7, 7), reads["all"])]


def fold_both(R: int, aggs, preds) -> list:
    """[(label, (JAX ivec, fvec), (port ivec, fvec), dev aggs)] of one
    signature over every case of ``cases``."""
    import jax.numpy as jnp

    side = planes_at(R)
    B = BLOCKS[R]
    jsig = signature(j_scan, B, R, aggs, preds)
    tsig = signature(t_scan, B, R, aggs, preds)
    jfn = j_agg_fold.compiled_full_aggregate(jsig)
    tfn = agg_fold.compiled_full_aggregate(tsig)
    lits = tuple(lit(KIND[c], v) for c, _op, v in preds)
    out = []
    for label, lo, hi, wf, wl, rd in cases(R, side["reads"]):
        reads = read_planes(rd)
        ji, jf = jfn(side["jax"], jnp.int32(lo), jnp.int32(hi),
                     jnp.int32(wf), jnp.int32(wl),
                     *(jnp.int32(v) for v in reads),
                     tuple(jnp.asarray(x) for x in lits))
        ti, tf = tfn(side["port"], lo, hi, wf, wl, *reads, lits)
        out.append((label, (np.asarray(ji), np.asarray(jf)),
                    (ti.numpy(), tf.numpy()), tsig.aggs))
    return out


def assert_same(results) -> int:
    """ivec digit for digit, finalized floats within the tolerance;
    returns the rows the cases scanned."""
    scanned = 0
    for label, (ji, jf), (ti, tf), aggs in results:
        assert ti.dtype == ji.dtype == np.int32, label
        assert np.array_equal(ti, ji), (label, ti, ji)
        assert tf.shape == jf.shape, label
        jacc, jn = agg_fold.unpack(aggs, ji, jf)
        tacc, tn = agg_fold.unpack(aggs, ti, tf)
        assert tn == jn, label
        scanned += tn
        for ag, ja, ta in zip(aggs, jacc, tacc):
            want = agg_fold.finalize(ag, ja, ag.fn)
            got = agg_fold.finalize(ag, ta, ag.fn)
            if isinstance(want, float):
                assert got == pytest.approx(want, rel=1e-5, abs=1e-3), \
                    (label, ag)
            else:
                assert got == want, (label, ag)
    return scanned


@pytest.mark.parametrize("R", sorted(BLOCKS))
@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_port_ivec_equals_jax_digit_for_digit(R, name):
    results = fold_both(R, *SIGNATURES[name])
    assert assert_same(results) > 0
    by = {label: r for label, *r in results}
    empty = by["empty_windows"][1][0]
    assert empty[0] == 0 and by["empty_range"][1][0][0] == 0
    if name == "null_columns":
        acc, _n = agg_fold.unpack(by["whole"][2], *by["whole"][1])
        vals = [agg_fold.finalize(a, x, a.fn)
                for a, x in zip(by["whole"][2], acc)]
        assert vals[0] > 0 and vals[1:] == [0, None, None, None] * 2


@pytest.mark.parametrize("op", OPS)
def test_every_f64_predicate_op(op):
    """Each comparison on an f64 column's ordered planes, at a literal
    that is a stored value (so '=' matches rows)."""
    R = 48
    side = planes_at(R)["planes"]
    planes = side["cols"][4]
    # A stored value on a row with no TTL, so that '=' matches it.
    ok = (planes["set"] & ~planes["isnull"]
          & (side["exp_hi"] == side["exp_hi"].max())).reshape(-1)
    hit = planes["cmp"].reshape(-1, 2)[np.flatnonzero(ok)[40]]
    value = float(P.ordered_planes_to_f64(hit[:1], hit[1:])[0])
    results = fold_both(R, SIGNATURES["floats"][0], [(4, op, value)])
    assert assert_same(results) > 0


def test_sums_at_the_extremes_need_every_digit():
    """Sums of values at the i64 extremes carry into digits past the
    fourth: the digits (not only the total) still match."""
    results = fold_both(8, [("sum", 2), ("count", 2)], [])
    assert_same(results)
    ivec = results[0][2][0]
    assert any(ivec[1 + j] for j in range(4, agg_fold.DIGITS))


def test_carry_step_and_window_bounds_follow_the_jax_program():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for _ in range(20):
        digits = rng.integers(0, 1 << 30, agg_fold.DIGITS)
        want = np.asarray(j_agg_fold.carry_step(jnp.asarray(digits,
                                                            jnp.int32)))
        assert agg_fold.carry_step(digits.tolist()) == want.tolist()
    for lo, hi in ((0, 0), (5, 4), (0, 1), (63, 65), (511, 513), (0, 10**6),
                   (700, 10**6)):
        assert agg_fold.window_bounds(lo, hi, 8, K, 12) == \
            j_agg_fold.window_bounds(lo, hi, 8, K, 12)


def test_fold_window_matches_the_whole_fold():
    """``fold_window`` window by window gives what the fold over the
    windows gives."""
    R = 64
    side = planes_at(R)
    aggs, preds = SIGNATURES["floats"]
    sig = signature(t_scan, BLOCKS[R], R, aggs, preds)
    lits = tuple(lit(KIND[c], v) for c, _op, v in preds)
    reads = read_planes(side["reads"]["mid"])
    n, W = BLOCKS[R] * R, BLOCKS[R] // K
    carry = (agg_fold.agg_init(sig.aggs), 0)
    for w in range(W):
        carry = agg_fold.fold_window(sig, side["port"], w, carry, 3, n - 3,
                                     reads, lits)
    ivec, fvec = agg_fold.pack(sig.aggs, carry[0], torch.tensor(carry[1]))
    want = agg_fold.full_aggregate_plain(sig, side["port"], 3, n - 3, 0, W,
                                         *reads, lits)
    assert torch.equal(ivec, want[0]) and torch.equal(fvec, want[1])


# -- the plan, the descriptor and the launch shape (pure Python) -------------

def plan_of(aggs, preds, R=64):
    sig = signature(t_scan, 1, R, aggs, [(c, op, 0) for c, op in preds])
    return full_agg.make_plan(sig.aggs, sig.preds, sig.cols, R, K)


def test_supports_refuses_what_k5_does_not_take():
    base = signature(t_scan, 1, 64, [("sum", 4)], [(4, ">", 0)])
    assert full_agg.supports(base)
    for bad in (
            signature(t_scan, 1, 64, [("sum", 4)], [(3, ">", 0)]),  # f32
            dataclasses.replace(base, flat=False),
            dataclasses.replace(base, R=8192)):
        assert not full_agg.supports(bad)
    assert not full_agg.supports(t_scan.ScanSig(
        B=1, R=64, K=K, cols=(t_scan.ColSig(1, "str"),), preds=(),
        aggs=(t_scan.AggSig("sum", 1, "str"),), apply_preds=True, flat=True))
    with pytest.raises(ValueError, match="missing from cols"):
        full_agg.make_plan((t_scan.AggSig("sum", 99, "i64"),), (),
                           base.cols, 64, K)


def test_plan_layouts_match_pack():
    """Output offsets follow ``agg_fold.pack``; literal offsets and the
    descriptor's tables follow the plan."""
    aggs = [("count", None), ("sum", 3), ("sum", 2), ("min", 7), ("max", 1),
            ("min", 4), ("count", 6)]
    plan = plan_of(aggs, [(1, ">="), (4, "<"), (2, "!=")])
    acc = agg_fold.agg_init(plan.aggs)
    ivec, fvec = agg_fold.pack(plan.aggs, acc, torch.tensor(0))
    assert (plan.n_ints, plan.n_floats) == (ivec.numel(), fvec.numel())
    assert plan.ioffs == [1, 2, 3, 12, 13, 15, 18]
    assert plan.foffs == [0, 0, 2, 2, 3, 3, 3]
    assert plan.lit_offsets == [8, 9, 11] and plan.n_params == 13
    assert plan.rec_words == 1 + 5 * 7
    table = plan.plane_table(planes_at(64)["port"])
    words = plan.descriptor(table)
    assert list(words[:8]) == [17, 3, 7, 13, plan.n_ints, plan.n_floats,
                               64, 64 * K]
    off_cols, off_preds, off_aggs, off_ptrs = words[8:12]
    assert (off_preds - off_cols, off_aggs - off_preds,
            off_ptrs - off_aggs) == (2 * 17, 4 * 3, 5 * 7)
    assert list(words[off_cols:off_cols + 8]) == [1, 1, 2, 1, 1, 1, 2, 1]
    assert list(words[off_preds + 4:off_preds + 8]) == [3, 3, 2, 9]
    assert list(words[off_aggs + 15:off_aggs + 20]) == [2, 6, 2, 12, 2]
    assert words.size == off_ptrs + 7 + 4 * 17
    assert words[off_ptrs] == table[0].data_ptr()


def test_param_rows_and_literals_round_trip():
    plan = plan_of([("sum", 4)], [(1, "<"), (4, ">=")])
    lits = (np.int32(-7), lit("f64", 2.5))
    row = plan.param_row(-5, 1 << 40, 1, 9, (1, 2, 3, 4), lits)
    assert row[:8] == [0, (1 << 31) - 1, 1, 9, 1, 2, 3, 4]
    back = plan.literals(row)
    assert int(back[0]) == -7 and np.array_equal(back[1], lits[1])


def test_launch_geometry():
    plan = plan_of([("sum", 4), ("count", None)], [])
    rows = np.array([plan.param_row(0, 10, wf, wl, (0, 0, 0, 0), ())
                     for wf, wl in ((3, 7), (5, 5), (1, 4), (6, 9))],
                    np.int32)
    geo = full_agg.launch_geometry(plan, rows, 12)
    assert geo == {"w_base": 1, "windows": 8, "specs": 4, "threads": 256,
                   "fold_threads": 96, "rec_words": 11}
    empty = full_agg.launch_geometry(plan, rows[1:2], 12)
    assert (empty["w_base"], empty["windows"]) == (0, 0)
    with pytest.raises(ValueError, match="outside the run"):
        full_agg.launch_geometry(plan, rows, 8)
    wide = plan_of([("count", None)] * 40, [])
    assert full_agg.launch_geometry(wide, rows[:1], 12)["fold_threads"] \
        == 1024


def test_full_aggregate_runs_the_plain_version_on_cpu_only():
    R = 64
    side = planes_at(R)
    aggs, preds = SIGNATURES["floats"]
    sig = signature(t_scan, BLOCKS[R], R, aggs, preds)
    plan = full_agg.make_plan(sig.aggs, sig.preds, sig.cols, R, K)
    lits = tuple(lit(KIND[c], v) for c, _op, v in preds)
    n, W = BLOCKS[R] * R, BLOCKS[R] // K
    reads = read_planes(side["reads"]["all"])
    params = np.array([plan.param_row(0, n, 0, W, reads, lits),
                       plan.param_row(9, n // 2, 0, W, reads, lits)],
                      np.int32)
    launches = full_agg.full_aggregate.launches
    ivec, fvec = full_agg.full_aggregate(plan, side["port"], params)
    assert full_agg.full_aggregate.launches == launches
    assert ivec.shape == (2, plan.n_ints) and fvec.shape == (2,
                                                             plan.n_floats)
    for k, row in enumerate(params.tolist()):
        want = agg_fold.full_aggregate_plain(sig, side["port"], row[0],
                                             row[1], row[2], row[3],
                                             *reads, lits)
        assert torch.equal(ivec[k], want[0]) and torch.equal(fvec[k],
                                                             want[1])
    meta = {k: ({c: {m: t.to("meta") for m, t in e.items()}
                 for c, e in v.items()} if k == "cols" else v.to("meta"))
            for k, v in side["port"].items()}
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        full_agg.full_aggregate(plan, meta, params)


# -- the plane generator ------------------------------------------------------

def test_flat_planes_layout_and_flat_fold_agreement():
    """``workload.flat_planes``: the ``DeviceRun.arrays`` layout, each
    kind's order and arith planes, the never-set and all-NULL columns;
    under the flat fold's bounds the plain flat fold and K5's plain
    version finalize to the same values on its planes."""
    R, B = 64, 64
    planes, reads = workload.flat_planes(B, R, COLUMNS, seed=5)
    assert set(planes) == {"valid", "group_start", "tomb", "live", "ht_hi",
                           "ht_lo", "exp_hi", "exp_lo", "cols"}
    for name in ("valid", "group_start", "tomb", "live"):
        assert planes[name].shape == (B, R) and planes[name].dtype == bool
    for name in ("ht_hi", "ht_lo", "exp_hi", "exp_lo"):
        assert planes[name].shape == (B, R) and \
            planes[name].dtype == np.int32
    assert planes["group_start"].all()
    valid, tomb = planes["valid"], planes["tomb"]
    assert 0 < (~valid).sum() < 0.02 * B * R and (tomb & ~valid).sum() == 0
    assert reads["early"] < reads["mid"] < reads["all"]
    for cid, kind, _ps, _pn, _pe in COLUMNS:
        c = planes["cols"][cid]
        width = 1 if kind in ("i32", "f32") else 2
        assert c["cmp"].shape == (B, R, width) and c["cmp"].dtype == np.int32
        assert c["arith"].shape == (B, R) and c["arith"].dtype == np.float32
        assert not (c["set"] & (tomb | ~valid)).any()
        assert not (c["isnull"] & ~c["set"]).any()
        keep = c["set"] & ~c["isnull"]
        assert not c["cmp"][~keep].any() and not c["arith"][~keep].any()
        if kind == "f64" and keep.any():
            hi, lo = c["cmp"][keep][:, 0], c["cmp"][keep][:, 1]
            values = P.ordered_planes_to_f64(hi, lo)
            with np.errstate(over="ignore"):
                assert np.array_equal(values.astype(np.float32),
                                      c["arith"][keep])
        if kind == "f32":
            assert np.array_equal(c["cmp"][keep][:, 0].view(np.float32),
                                  c["arith"][keep])
    assert not planes["cols"][6]["set"].any()
    assert planes["cols"][8]["set"].any()
    assert np.array_equal(planes["cols"][8]["set"],
                          planes["cols"][8]["isnull"])
    ext = planes["cols"][2]["cmp"].reshape(-1, 2)
    extremes = P.ordered_planes_to_i64(ext[:, 0], ext[:, 1])
    assert (extremes == np.iinfo(np.int64).max).any()

    arrays = DeviceRun.from_reference_planes(planes, R, "cpu").arrays
    aggs, preds = SIGNATURES["floats"]
    aggs = aggs + SIGNATURES["ints"][0]
    sig = signature(t_scan, B, R, aggs, preds)
    assert flat_fold.supports(sig)
    lits = tuple(lit(KIND[c], v) for c, _op, v in preds)
    reads_ = read_planes(reads["mid"])
    fi, ff = flat_fold.compiled_flat_aggregate(sig)(arrays, 5, B * R - 9,
                                                    *reads_, lits)
    ki, kf = agg_fold.full_aggregate_plain(sig, arrays, 5, B * R - 9, 0,
                                           B // K, *reads_, lits)
    facc, fn = agg_fold.unpack(sig.aggs, fi, ff)
    kacc, kn = agg_fold.unpack(sig.aggs, ki, kf)
    assert fn == kn > 0
    for ag, fa, ka in zip(sig.aggs, facc, kacc):
        want = agg_fold.finalize(ag, fa, ag.fn)
        got = agg_fold.finalize(ag, ka, ag.fn)
        if isinstance(want, float):
            assert got == pytest.approx(want, rel=1e-5, abs=1e-3), ag
        else:
            assert got == want, ag
