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
MODEL_BLOCKS = {33: 40, 100: 24}  # the partition model's other R
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

        planes, reads = workload.flat_planes({**MODEL_BLOCKS, **BLOCKS}[R],
                                             R, COLUMNS, seed=R)
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
    # One pass a column that an aggregate reads, in order of first use:
    # SUM(3) f32 (arith), SUM(2) i64 (two order words), MIN(7) f32 (arith),
    # MAX(1) i32 (one word), MIN(4) f64 (two words), COUNT(6) alone.
    assert plan.agg_pass == [-1, 0, 1, 2, 3, 4, 5]
    sl = plan.slot
    assert plan.staged == [(sl[1], 0), (sl[4], 0), (sl[4], 1), (sl[2], 0),
                           (sl[2], 1), (sl[3], -1), (sl[7], -1)]
    assert plan.pred_staged == [(0, -1), (1, 2), (3, 4)]
    assert plan.passes == [(sl[3], 2, 1, -1, -1, 5), (sl[2], 1, 1, 3, 4, -1),
                           (sl[7], 2, 2, -1, -1, 6), (sl[1], 0, 4, 0, -1, -1),
                           (sl[4], 3, 2, 1, 2, -1), (sl[6], 0, 0, -1, -1, -1)]
    # The tile buffer holds each read column's order planes (all of its
    # words) and arith plane once, as they lie.
    assert plan.raw == [(sl[1], 0, 1, 0), (sl[4], 0, 2, 1), (sl[2], 0, 2, 3),
                        (sl[3], 1, 1, 5), (sl[7], 1, 1, 6)]
    assert plan.val_words == 7
    assert plan.staged_at == [(0, 1, 0), (1, 2, 0), (1, 2, 1), (3, 2, 0),
                              (3, 2, 1), (5, 1, 0), (6, 1, 0)]
    table = plan.plane_table(planes_at(64)["port"])
    words = plan.descriptor(table)
    assert list(words[:11]) == [17, 3, 7, 13, plan.n_ints, plan.n_floats,
                                64, 64 * K, 6, 7, 5]
    off_preds, off_aggs, off_passes, off_staged, off_raw, off_ptrs = \
        words[11:17]
    assert (off_preds, off_aggs - off_preds, off_passes - off_aggs,
            off_staged - off_passes, off_raw - off_staged,
            off_ptrs - off_raw) == (17, 6 * 3, 6 * 7, 6 * 6, 5 * 7, 4 * 5)
    assert list(words[off_staged + 10:off_staged + 15]) == [sl[4], 1, 1, 2,
                                                            1]
    assert list(words[off_raw + 4:off_raw + 8]) == [sl[4], 0, 2, 1]
    # The f64 predicate: slot, kind, op, literal word 1, staged words.
    assert list(words[off_preds + 6:off_preds + 12]) == [3, 3, 2, 1, 1, 2]
    assert list(words[off_aggs + 18:off_aggs + 24]) == [2, 6, 2, 12, 2, 2]
    assert list(words[off_passes + 24:off_passes + 30]) == [3, 3, 2, 1, 2,
                                                            -1]
    assert words.size == off_ptrs + 7 + 4 * 17 == plan.desc_words
    assert words[off_ptrs] == table[0].data_ptr()


def test_param_rows_and_literals_round_trip():
    plan = plan_of([("sum", 4)], [(1, "<"), (4, ">=")])
    lits = (np.int32(-7), lit("f64", 2.5))
    row = plan.param_row(-5, 1 << 40, 1, 9, (1, 2, 3, 4), lits)
    assert row[:8] == [0, (1 << 31) - 1, 1, 9, 1, 2, 3, 4]
    back = plan.literals(row)
    assert int(back[0]) == -7 and np.array_equal(back[1], lits[1])


def geo_rows(plan, spans, reads=(0, 0, 0, 0)):
    return np.array([plan.param_row(0, 10, wf, wl, reads, ())
                     for wf, wl in spans], np.int32)


def test_launch_geometry():
    plan = plan_of([("sum", 4), ("count", None)], [])
    rows = geo_rows(plan, ((3, 7), (5, 5), (1, 4), (6, 9)))
    geo = full_agg.launch_geometry(plan, rows, 12)
    assert tuple(geo) == full_agg.GEOMETRY
    # 4 specs: one chunk, 2 warps a spec; 512-row windows (R = 64) under
    # BLOCK_ROWS, but the grid is far below TARGET_BLOCKS: a window a block.
    assert geo == dict(
        geo, w_base=1, windows=8, specs=4, chunk=4, chunks=1, tile_rows=512,
        windows_per_block=1, blocks=8, warps_per_spec=2, rows_per_load=2,
        async_copy=1, passes=1, staged=1, threads=256, fold_threads=96,
        rec_words=11)
    assert geo["read_classes"] == 1
    assert geo["shared_bytes"] == full_agg.shared_layout(plan, 4, 2, 512,
                                                         True, 1)
    empty = full_agg.launch_geometry(plan, rows[1:2], 12)
    assert (empty["w_base"], empty["windows"], empty["blocks"]) == (0, 0, 0)
    with pytest.raises(ValueError, match="outside the run"):
        full_agg.launch_geometry(plan, rows, 8)
    wide = plan_of([("count", None)] * 40, [])
    assert full_agg.launch_geometry(wide, rows[:1], 12)["fold_threads"] \
        == 32 * full_agg.FOLD_WARPS
    # One spec: every warp takes a slice of its tiles.
    one = full_agg.launch_geometry(plan, rows[:1], 12)
    assert (one["chunk"], one["warps_per_spec"]) == (1, 8)
    # Many small windows: a run of them a block, as far as the grid still
    # holds TARGET_BLOCKS blocks.
    many = full_agg.launch_geometry(plan, geo_rows(plan, ((0, 2149),) * 16),
                                    2149)
    assert (many["chunk"], many["warps_per_spec"]) == (16, 1)
    assert many["windows_per_block"] == -(-2149 // full_agg.TARGET_BLOCKS)
    assert many["blocks"] == -(-2149 // many["windows_per_block"])
    # 2048-row blocks: a 16,384-row window a block, in tiles of the
    # largest power of two whose two buffers let 3 blocks share an SM.
    big = plan_of([("sum", 4), ("count", None)], [], R=2048)
    g2 = full_agg.launch_geometry(big, geo_rows(big, ((0, 2112),)), 2112)
    assert (g2["tile_rows"], g2["windows_per_block"], g2["blocks"],
            g2["rows_per_load"], g2["async_copy"]) == (512, 1, 2112, 2, 1)
    assert full_agg.shared_layout(big, 1, 8, 1024, True, 1) > \
        full_agg.SMEM_LIMIT // full_agg.FEW_BLOCKS_PER_SM >= g2["shared_bytes"]
    # Planes off 16 bytes, or windows not a multiple of 16 rows: loaded
    # one row a thread.
    plain = full_agg.launch_geometry(big, geo_rows(big, ((0, 2112),)), 2112,
                                     aligned=False)
    assert (plain["rows_per_load"], plain["async_copy"]) == (1, 0)
    odd = plan_of([("count", None)], [], R=33)
    assert full_agg.launch_geometry(odd, geo_rows(odd, ((0, 5),)), 5)[
        "async_copy"] == 0


def test_launch_geometry_one_chunk_and_one_more_spec():
    """MAX_SPEC_CHUNK + 1 specs: two chunks, the specs dealt evenly."""
    plan = plan_of([("sum", 4), ("min", 4), ("max", 4)], [(4, ">=")])
    n = full_agg.MAX_SPEC_CHUNK + 1
    rows = geo_rows(plan, ((0, 5),) * n)
    geo = full_agg.launch_geometry(plan, rows, 5)
    assert (geo["specs"], geo["chunks"], geo["chunk"],
            geo["warps_per_spec"]) == (n, 2, 33, 1)
    assert geo["shared_bytes"] <= full_agg.SMEM_LIMIT
    classes, table = full_agg.read_classes(rows, geo["chunk"])
    assert table.shape == (2, full_agg.CLASS_WORDS)
    assert list(table[:, 0]) == [1, 1] and not classes.any()


def test_launch_geometry_more_aggregates_than_a_pass_holds():
    """A pass holds one column's SUM, MIN, MAX and COUNT: 12 aggregates
    over 3 columns are 3 passes, 12 over 12 columns 12 passes (the 18-column
    edge of the card's run)."""
    plan = plan_of([(fn, c) for c in (1, 2, 4) for fn in
                    ("sum", "min", "max", "count")], [])
    assert len(plan.passes) == 3
    assert plan.agg_pass == [0] * 4 + [1] * 4 + [2] * 4
    assert [p[2] for p in plan.passes] == [7, 7, 7]
    spread = plan_of([(fn, c) for fn, c in zip(
        ("sum", "min", "max", "count") * 3, range(6, 18))], [])
    assert len(spread.passes) == 12
    geo = full_agg.launch_geometry(spread, geo_rows(spread, ((0, 5),)), 5)
    assert geo["passes"] == 12 and geo["shared_bytes"] <= full_agg.SMEM_LIMIT


@pytest.mark.parametrize("R", (8, 33, 64, 100, 2048))
def test_shared_bytes_fit_a_block_at_every_window(R):
    """The widest plans the card's run launches (18 value columns, 10
    predicates, 12 aggregates; every column's order and arith planes
    staged) at every R that ``safe_window_blocks`` admits, alone and in
    batches of 1, 8, 65 and 512 specs."""
    kinds = ("i32", "i64", "f32", "f64")
    cols = tuple(t_scan.ColSig(c, kinds[c % 4]) for c in range(1, 19))
    kind = {cs.col_id: cs.kind for cs in cols}
    preds = tuple(t_scan.PredSig(c, kind[c], "<") for c in range(1, 19)
                  if kind[c] != "f32")[:10]
    aggs = tuple(t_scan.AggSig(fn, c, kind[c]) for c in range(1, 19)
                 for fn in ("sum", "min", "max"))
    Kr = agg_fold.safe_window_blocks(R, agg_fold.FULL_WINDOW_BLOCKS)
    plan = full_agg.make_plan(aggs, preds, cols, R, Kr)
    assert len(plan.staged) > 30
    for n in (1, 8, 65, 512):
        rows = np.array([plan.param_row(0, 10, 0, 3, (0, 0, 0, i), [
            np.int32(0) if p.kind == "i32" else np.zeros(2, np.int32)
            for p in preds]) for i in range(n)], np.int32)
        geo = full_agg.launch_geometry(plan, rows, 3)
        assert geo["shared_bytes"] <= 232448
        assert geo["shared_bytes"] == full_agg.shared_layout(
            plan, geo["chunk"], geo["warps_per_spec"], geo["tile_rows"],
            geo["async_copy"], geo["read_classes"])
        assert geo["chunk"] * geo["chunks"] >= n
        assert 32 * geo["warps_per_spec"] <= geo["tile_rows"]


def test_fold_digits_equal_one_carry_step_a_window():
    """The fold's closed form gives the digits of one ``carry_step`` a
    window, digit for digit: no window, fewer windows than it reads back,
    limb sums at the limb bound, at the carries' edges and drawn."""
    rng = np.random.default_rng(11)
    top = agg_fold._LIMB_BUDGET - 1
    for trial in range(400):
        T = int(rng.choice([0, 1, 2, 6, 7, 8, 9, 31, 33, 300]))
        pick = trial % 3
        if pick == 0:
            windows = rng.integers(0, top, (T, 4)).tolist()
        elif pick == 1:
            windows = rng.choice([0, 0xFFFF, 0x10000, top], (T, 4)).tolist()
        else:
            windows = rng.integers(0, 0xFFFF * 512, (T, 4)).tolist()
        digits = [0] * agg_fold.DIGITS
        for x in windows:
            digits = agg_fold.carry_step(
                [d + (x[k] if k < 4 else 0) for k, d in enumerate(digits)])
        assert full_agg.fold_digits(windows) == digits, windows


def test_read_classes():
    """Each chunk stages its first READ_CLASSES distinct read points; a
    spec past them gets -1."""
    plan = plan_of([("count", None)], [])
    reads = [(0, 0, 0, i % 11) for i in range(30)]
    rows = np.array([plan.param_row(0, 10, 0, 1, r, ()) for r in reads],
                    np.int32)
    classes, table = full_agg.read_classes(rows, 20)
    assert table.shape == (2, full_agg.CLASS_WORDS)
    assert list(table[:, 0]) == [8, 8]
    assert list(classes[:11]) == list(range(8)) + [-1, -1, -1]
    assert list(classes[11:20]) == list(range(8)) + [-1]
    assert list(classes[20:]) == list(range(8)) + [-1, -1]
    for c, lo in ((0, 0), (1, 20)):
        for s in range(lo, min(30, lo + 20)):
            if classes[s] >= 0:
                k = 1 + 4 * classes[s]
                assert tuple(table[c, k:k + 4]) == tuple(rows[s, 4:8])


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


# -- a numpy model of the kernel's partition ---------------------------------

def row_keys(hi, lo):
    """int64 keys whose order is the (hi, lo) int32 planes' lexicographic
    order."""
    return hi.astype(np.int64) * (1 << 32) + (lo.astype(np.int64) + (1 << 31))


def model_rows(plan, planes) -> dict:
    """What the staging decodes once per row, as flat numpy arrays: the
    candidate bit, each slot's set-and-not-NULL bit, the hybrid-time and
    expiry keys, each column's order key (signed value for i32) and arith
    plane."""
    flat = {k: v.reshape(-1) for k, v in planes.items() if k != "cols"}
    nn, key, arith, words = {}, {}, {}, {}
    for cs in plan.cols:
        c = planes["cols"][cs.col_id]
        slot = plan.slot[cs.col_id]
        nn[slot] = (c["set"] & ~c["isnull"]).reshape(-1)
        cmp = c["cmp"].reshape(-1, c["cmp"].shape[-1])
        words[slot] = cmp
        key[slot] = (cmp[:, 0].astype(np.int64) if cmp.shape[1] == 1
                     else row_keys(cmp[:, 0], cmp[:, 1]))
        arith[slot] = c["arith"].reshape(-1)
    exists = flat["live"] | np.logical_or.reduce(list(nn.values()))
    return {"cand": flat["valid"] & ~flat["tomb"] & exists, "nn": nn,
            "ht": row_keys(flat["ht_hi"], flat["ht_lo"]),
            "exp": row_keys(flat["exp_hi"], flat["exp_lo"]), "key": key,
            "arith": arith, "words": words}


_CMP = {"=": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
        ">": np.greater, ">=": np.greater_equal}


def model_resolve(plan, rows, spec, read, idx) -> np.ndarray:
    """The rows ``idx`` that count for one spec at read planes ``read``."""
    ok = rows["cand"][idx] & (rows["ht"][idx] <= row_keys(
        np.int32(read[0]), np.int32(read[1]))) & ~(
        rows["exp"][idx] <= row_keys(np.int32(read[2]), np.int32(read[3])))
    for p, off in zip(plan.preds, plan.lit_offsets):
        slot = plan.slot[p.col_id]
        x = (np.int64(spec[off]) if p.kind == "i32"
             else row_keys(np.int32(spec[off]), np.int32(spec[off + 1])))
        ok &= rows["nn"][slot][idx] & _CMP[p.op](rows["key"][slot][idx], x)
    return idx[ok]


def model_record(plan, rows, sel) -> dict:
    """One (spec, window)'s record from the rows ``sel`` that count, in
    ``agg_fold.window_parts``' form."""
    out = {"scanned": int(sel.size)}
    for i, a in enumerate(plan.aggs):
        if a.col_id is None:
            out[f"agg{i}_count"] = int(sel.size)
            continue
        slot = plan.slot[a.col_id]
        got = sel[rows["nn"][slot][sel]]
        n = int(got.size)
        if a.fn == "count":
            out[f"agg{i}_count"] = n
            continue
        out[f"agg{i}_n"] = n
        is_max = a.fn == "max"
        if a.fn == "sum" and a.kind in ("f32", "f64"):
            out[f"agg{i}_fsum"] = float(np.float32(
                rows["arith"][slot][got].astype(np.float64).sum()))
        elif a.fn == "sum":
            w = rows["words"][slot][got].astype(np.int64) & 0xFFFFFFFF
            u = w ^ 0x80000000
            limbs = [u[:, -1] & 0xFFFF, u[:, -1] >> 16]
            if u.shape[1] == 2:
                limbs += [u[:, 0] & 0xFFFF, u[:, 0] >> 16]
            out[f"agg{i}_limbs"] = [int(x.sum()) for x in limbs]
        elif a.kind == "f32":
            vals = rows["arith"][slot][got]
            out[f"agg{i}_fext"] = (vals.max() if is_max else vals.min()) \
                if n else np.float32(-np.inf if is_max else np.inf)
        else:
            keys = rows["key"][slot][got]
            if a.kind == "i32":
                fill = -(1 << 31) if is_max else (1 << 31) - 1
                out[f"agg{i}_ext"] = int(keys.max() if is_max
                                         else keys.min()) if n else fill
            else:
                fill = -(1 << 63) if is_max else (1 << 63) - 1
                k = int(keys.max() if is_max else keys.min()) if n else fill
                out[f"agg{i}_ext_hi"] = k >> 32
                out[f"agg{i}_ext_lo"] = (k & 0xFFFFFFFF) - (1 << 31)
    return out


def model_partition(plan, planes, params, W) -> tuple:
    """The kernel's partition in numpy: chunks of specs (grid.y), runs of
    windows (grid.x), each window's tiles, each tile's rows dealt to warps
    and lanes as ``csrc/full_agg.cu`` deals them, visibility from the
    chunk's read classes; per (spec, window) one record summed over its
    tiles and slices, then folded in window order (``agg_fold.agg_fold``:
    one carry step a window) and packed. Every row of a spec's windows in
    its range is counted exactly once. Returns (ivec [N, I], fvec [N, F],
    the geometry)."""
    geo = full_agg.launch_geometry(plan, params, W)
    classes, table = full_agg.read_classes(params, geo["chunk"])
    rows = model_rows(plan, planes)
    N, T, G = plan.K * plan.R, geo["tile_rows"], geo["warps_per_spec"]
    J = T // (32 * G)
    lane_rows = {q: np.array([(j * G + q) * 32 + lane for j in range(J)
                              for lane in range(32)]) for q in range(G)}
    assert np.array_equal(np.sort(np.concatenate(list(lane_rows.values()))),
                          np.arange(T))
    records, seen = {}, {}
    for c in range(geo["chunks"]):
        chunk = range(c * geo["chunk"], min(len(params),
                                            (c + 1) * geo["chunk"]))
        live = [s for s in chunk if params[s, 2] < params[s, 3]]
        if not live:
            continue
        uwf, uwl = min(params[s, 2] for s in live), max(params[s, 3]
                                                        for s in live)
        ulo, uhi = min(params[s, 0] for s in live), max(params[s, 1]
                                                        for s in live)
        for b in range(geo["blocks"]):
            wb = geo["w_base"] + b * geo["windows_per_block"]
            we = min(wb + geo["windows_per_block"],
                     geo["w_base"] + geo["windows"])
            for w in range(max(wb, uwf), min(we, uwl)):
                acc = {s: [] for s in chunk
                       if params[s, 2] <= w < params[s, 3]}
                lo_s, hi_s = max(w * N, ulo), min((w + 1) * N, uhi)
                # With the copy, tiles start on a multiple of 16 rows.
                align = 16 if geo["async_copy"] else 1
                for t0 in range(lo_s - lo_s % align, hi_s, T):
                    nt = min(T, hi_s - t0)
                    for s in acc:
                        cls = classes[s]
                        read = (table[c, 1 + 4 * cls:5 + 4 * cls] if cls >= 0
                                else params[s, 4:8])
                        for q in range(G):
                            r = lane_rows[q]
                            g = t0 + r[(r < nt) & (t0 + r >= params[s, 0])
                                       & (t0 + r < params[s, 1])]
                            for x in g:
                                seen[s, int(x)] = seen.get((s, int(x)), 0) + 1
                            acc[s].append(model_resolve(
                                plan, rows, params[s], read, g))
                for s, parts in acc.items():
                    assert (s, w) not in records
                    records[s, w] = model_record(
                        plan, rows, np.concatenate(parts) if parts
                        else np.zeros(0, np.int64))
    ivecs, fvecs = [], []
    for s, prm in enumerate(params):
        lo, hi, wf, wl = (int(x) for x in prm[:4])
        want = {(s, x) for w in range(wf, wl)
                for x in range(max(lo, w * N), min(hi, (w + 1) * N))}
        assert {k for k in seen if k[0] == s} == want
        assert all(seen[k] == 1 for k in want)
        acc, scanned = agg_fold.agg_init(plan.aggs), 0
        for w in range(wf, wl):
            parts = records[s, w]
            acc = agg_fold.agg_fold(plan.aggs, acc, parts)
            scanned += parts["scanned"]
        iv, fv = agg_fold.pack(plan.aggs, acc, torch.tensor(scanned))
        ivecs.append(iv.numpy())
        fvecs.append(fv.numpy())
    return np.stack(ivecs), np.stack(fvecs), geo


def model_specs(plan, R: int, reads: dict, n_specs: int) -> np.ndarray:
    """Parameter rows: ranges that start and end mid-window, an empty
    range, a window range narrower than the rows, and read points at the
    run's newest, mid, early and in between (more than READ_CLASSES
    distinct ones when there are enough specs)."""
    B = {**MODEL_BLOCKS, **BLOCKS}[R]
    n, W, N = B * R, B // K, K * R
    pts = [reads["all"], reads["mid"], reads["early"]] + [
        reads["early"] + (reads["all"] - reads["early"]) * i // 9
        for i in range(1, 9)]
    lits = tuple(lit(KIND[c], v) for c, _op, v in plan.model_preds)
    out = []
    for i in range(n_specs):
        lo, hi = [(0, n), (R + 3, n - 2 * R - 5), (N + 1, 2 * N - 1),
                  (7, 7), (N // 2 + 5, n - N // 2 - 3), (3, n)][i % 6]
        wf, wl = agg_fold.window_bounds(lo, hi, R, K, W)
        if i % 6 == 5:
            wf, wl = 1, W - 1
        out.append(plan.param_row(lo, hi, wf, wl,
                                  read_planes(pts[i % len(pts)]), lits))
    return np.array(out, np.int32)


@pytest.mark.parametrize("R", (8, 33, 64, 100))
@pytest.mark.parametrize("name", ("ints", "floats"))
@pytest.mark.parametrize("shape", ("one_spec", "specs", "small_chunks"))
def test_partition_model_equals_plain_and_jax(R, name, shape, monkeypatch):
    """The records that ``launch_geometry``'s partition sums, folded with
    one carry step a window, equal the plain version and the JAX program
    digit for digit. ``small_chunks`` shrinks MAX_SPEC_CHUNK to 4 and
    TARGET_BLOCKS to 2, so that 13 specs take 4 chunks of 2 warps a spec
    and a block runs several windows."""
    import jax.numpy as jnp

    if shape == "small_chunks":
        monkeypatch.setattr(full_agg, "MAX_SPEC_CHUNK", 4)
        monkeypatch.setattr(full_agg, "TARGET_BLOCKS", 2)
    side = planes_at(R)
    B = {**MODEL_BLOCKS, **BLOCKS}[R]
    aggs, preds = SIGNATURES[name]
    tsig = signature(t_scan, B, R, aggs, preds)
    plan = full_agg.make_plan(tsig.aggs, tsig.preds, tsig.cols, R, K)
    plan.model_preds = preds
    params = model_specs(plan, R, side["reads"],
                         {"one_spec": 1, "specs": 13, "small_chunks": 13}[
                             shape])
    ivec, fvec, geo = model_partition(plan, side["planes"], params, B // K)
    if shape == "small_chunks":
        assert geo["chunks"] == 4 and geo["warps_per_spec"] == 2
        assert geo["windows_per_block"] > 1
    if shape == "one_spec":
        assert geo["warps_per_spec"] == 8
    want_i, want_f = full_agg.full_aggregate(plan, side["port"], params)
    assert np.array_equal(ivec, want_i.numpy())
    assert ivec[:, 0].sum() > 0
    jfn = j_agg_fold.compiled_full_aggregate(
        signature(j_scan, B, R, aggs, preds))
    for k, row in enumerate(params.tolist()):
        ji, jf = jfn(side["jax"], *(jnp.int32(v) for v in row[:8]),
                     tuple(jnp.asarray(x) for x in plan.literals(row)))
        assert np.array_equal(ivec[k], np.asarray(ji)), k
        got = agg_fold.unpack(plan.aggs, ivec[k], fvec[k])[0]
        for ref in (want_f[k].numpy(), np.asarray(jf)):
            for ag, x, y in zip(plan.aggs, got,
                                agg_fold.unpack(plan.aggs, ivec[k], ref)[0]):
                a = agg_fold.finalize(ag, x, ag.fn)
                b = agg_fold.finalize(ag, y, ag.fn)
                if ag.fn == "sum" and ag.kind in ("f32", "f64") and a:
                    assert a == pytest.approx(b, rel=1e-5, abs=1e-3), ag
                else:
                    assert a == b, ag


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
