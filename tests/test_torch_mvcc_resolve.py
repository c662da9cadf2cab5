"""The MVCC resolve (``ops.mvcc_resolve``) against the JAX package's K4.

The resolved flat view of a multi-version run, built by the wrapper on
CPU tensors (the plain version of ``csrc/mvcc_resolve.cu``), fed to the
flat folds (``flat_agg.flat_aggregate_plain``, K1's arithmetic, and
``flat_fold``) must finalize to what the JAX package's
``seg_fold.compiled_seg_aggregate`` gives on the run's own planes: the
same scanned count and the same values (integers exactly, float sums
within rel 1e-5 / abs 1e-3, the tolerance of ``tests/test_seg_fold.py``).
Read points with one view key give byte-identical views; read points on
either side of a version's hybrid time or of a TTL expiry get different
keys. ``view_bytes`` charges each plane only where the resolve needs it.
The long-group planes (``workload.long_group_planes``: groups of up to a
whole block, straddling 32-row warp steps, at R = 64 and at R = 48, not a
multiple of 32) keep the layout's invariants and fold to what
``compiled_seg_aggregate`` gives on them, at read points that include a
tombstone's hybrid time, where its tied write is shadowed.
"""

import numpy as np
import pytest
import torch

from test_torch_data import (JAX, MAX_HT, PORT, build_run, make_schema,
                             multiversion_rows, read_planes,
                             reference_planes)
from test_torch_seg_fold import R, K, jax_arrays, sig_of
from yugabyte_db_tpu.ops import agg_fold as j_agg_fold
from yugabyte_db_tpu.ops import scan as j_scan
from yugabyte_db_tpu.ops import seg_fold as j_seg_fold
import yugabyte_db_tpu_torch.storage as T
from yugabyte_db_tpu_torch import workload
from yugabyte_db_tpu_torch.ops import agg_fold, flat_agg, flat_fold
from yugabyte_db_tpu_torch.ops import mvcc_resolve
from yugabyte_db_tpu_torch.ops import scan as t_scan
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun, dtype_kind
from yugabyte_db_tpu_torch.utils import planes as P


@pytest.fixture(scope="module")
def run():
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jrows, max_ht = multiversion_rows(JAX, js, seed=8, hot=0.045)
    prows, _ = multiversion_rows(PORT, ps, seed=8, hot=0.045)
    crun = build_run(JAX, js, jrows, R)
    planes = reference_planes(crun, K)
    port = DeviceRun.from_reference_planes(planes, R, "cpu")
    eng = T.make_engine("gpu", ps, {"rows_per_block": R, "device": "cpu"})
    eng.apply(prows)
    eng.flush()
    return {"crun": crun, "planes": planes, "max_ht": max_ht,
            "cid": {c.name: c.col_id for c in ps.value_columns},
            "kinds": {c.col_id: dtype_kind(c.dtype)
                      for c in ps.value_columns},
            "jax_arrays": jax_arrays(planes), "port": port,
            "const": mvcc_resolve.constant_planes(port.B, R, "cpu"),
            "trun": eng.runs[0]}


def view_at(run, read_ht):
    return mvcc_resolve.resolve_view(run["port"].arrays,
                                     *read_planes(P, read_ht), run["const"])


def pred_of(run):
    return (run["cid"]["d"], "i32", ">="), np.int32(-300_000)


@pytest.mark.parametrize("read", ["ht/3", "ht/2", "ht", "MAX_HT"])
def test_view_folds_to_jax_seg_fold(run, read):
    read_ht = {"ht/3": run["max_ht"] // 3, "ht/2": run["max_ht"] // 2,
               "ht": run["max_ht"], "MAX_HT": MAX_HT}[read]
    pred, lit = pred_of(run)
    assert_view_folds_to_jax(
        run["jax_arrays"], sig_of(j_scan, run, [pred]),
        sig_of(t_scan, run, [pred], flat=True), lambda: view_at(run, read_ht),
        run["kinds"], pred, lit, read_ht, run["crun"].total_rows())


def assert_view_folds_to_jax(jax_arrays, jsig, tsig, make_view, kinds, pred,
                             lit, read_ht, total):
    """The view (``make_view()``, resolved on CPU tensors) folded by
    ``flat_fold`` and by K1's plain version finalizes to what
    ``compiled_seg_aggregate`` gives on the run."""
    args = (0, total, *read_planes(P, read_ht), (lit,))
    ji, jf = j_seg_fold.compiled_seg_aggregate(jsig)(jax_arrays, *args)
    acc, want_scanned = j_agg_fold.unpack(jsig.aggs, np.asarray(ji),
                                          np.asarray(jf))
    want = [j_agg_fold.finalize(ag, a, ag.fn)
            for ag, a in zip(jsig.aggs, acc)]
    assert want_scanned > 0

    launches = mvcc_resolve.resolve_view.launches
    view = make_view()
    assert mvcc_resolve.resolve_view.launches == launches  # plain version
    # flat_fold over the view: every aggregate, floats included.
    ti, tf = flat_fold.compiled_flat_aggregate(tsig)(view, *args)
    tacc, scanned = agg_fold.unpack(tsig.aggs, np.asarray(ti),
                                    np.asarray(tf))
    assert scanned == want_scanned
    for ag, w, a in zip(tsig.aggs, want, tacc):
        got = agg_fold.finalize(ag, a, ag.fn)
        if ag.fn == "sum" and ag.kind == "f64":
            assert got == pytest.approx(w, rel=1e-5, abs=1e-3)
        else:
            assert got == w, ag
    # K1's arithmetic over the view: the integer aggregates.
    k1 = [i for i, ag in enumerate(tsig.aggs) if ag.kind != "f64"]
    plan = flat_agg.make_plan(tuple(tsig.aggs[i] for i in k1),
                              (t_scan.PredSig(*pred),), tuple(kinds))
    params = torch.tensor([plan.param_row(0, total, read_planes(P, read_ht),
                                          (lit,))], dtype=torch.int32)
    folded = flat_agg.fold_partials(plan, flat_agg.flat_aggregate_plain(
        plan, plan.plane_table(view), params))
    count, _exists, vals = plan.combine(folded[0].tolist())
    assert count == want_scanned
    assert vals == [want[i] for i in k1]


def planes_of(view):
    out = {k: v for k, v in view.items() if k != "cols"}
    for cid, c in view["cols"].items():
        out.update({f"{cid}.{k}": v for k, v in c.items()})
    return out


def assert_same_bytes(a, b):
    pa, pb = planes_of(a), planes_of(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape, k
        assert np.array_equal(pa[k].numpy().view(np.uint8),
                              pb[k].numpy().view(np.uint8)), k


def version_hts(run):
    """Sorted commit and TTL-expiry hybrid times of the run's versions."""
    crun = run["crun"]
    v = crun.valid
    hts = P.planes_to_u64(crun.ht_hi[v], crun.ht_lo[v]).astype(np.int64)
    exps = P.planes_to_u64(crun.exp_hi[v], crun.exp_lo[v]).astype(np.int64)
    return np.unique(hts), np.unique(exps[exps != MAX_HT])


def test_read_points_of_one_key_give_byte_identical_views(run):
    trun = run["trun"]
    hts, exps = version_hts(run)
    marks = set(hts.tolist()) | set(exps.tolist())
    # Read points r < r2 with no version and no expiry in (r, r2].
    pairs = [(int(h), int(h) + 1) for h in hts[len(hts) // 3:]
             if int(h) + 1 not in marks][:3]
    pairs.append((max(marks) + 1, MAX_HT))  # past every version and expiry
    assert len(pairs) == 4
    for r1, r2 in pairs:
        assert trun.view_key(r1) == trun.view_key(r2)
        assert_same_bytes(view_at(run, r1), view_at(run, r2))


def test_either_side_of_a_version_or_an_expiry_gets_another_key(run):
    trun = run["trun"]
    hts, exps = version_hts(run)
    assert len(exps) > 5
    for h in list(hts[::97]) + list(exps):
        h = int(h)
        assert trun.view_key(h - 1) != trun.view_key(h), h
    # An expiry that turns a latest setter NULL changes the view itself.
    changed = [int(e) for e in exps
               if not np.array_equal(
                   view_at(run, int(e) - 1)["cols"][run["cid"]["a"]]
                   ["isnull"].numpy(),
                   view_at(run, int(e))["cols"][run["cid"]["a"]]
                   ["isnull"].numpy())]
    assert changed


def test_view_layout_and_wrapper_checks(run):
    view = view_at(run, run["max_ht"])
    arrays = run["port"].arrays
    rep = arrays["group_start"] & arrays["valid"]
    assert torch.equal(view["valid"], rep)
    for name in ("ht_hi", "ht_lo", "exp_hi", "exp_lo", "tomb",
                 "group_start"):
        assert view[name] is run["const"][name]
    for cid, c in view["cols"].items():
        assert not (c["set"] & ~rep).any()
        assert not (c["isnull"] & ~c["set"]).any()
        assert c.keys() == arrays["cols"][cid].keys()
        assert not c["cmp"][~c["set"]].any()
    bad = dict(arrays, valid=arrays["valid"].to(torch.int32))
    with pytest.raises(ValueError):
        mvcc_resolve.resolve_view(bad, *read_planes(P, 10), run["const"])
    with pytest.raises(ValueError):
        mvcc_resolve.resolve_view(
            arrays, *read_planes(P, 10),
            dict(run["const"], tomb=run["const"]["tomb"][:, :-1]))


def test_view_bytes_charges_each_plane_where_the_resolve_needs_it(run):
    arrays = run["port"].arrays
    n = arrays["valid"].numel()
    valid = int(arrays["valid"].sum())
    widths = {cid: 4 * c["cmp"].shape[2] + (4 if "arith" in c else 0)
              for cid, c in arrays["cols"].items()}
    writes = 2 * n + sum(n * (2 + w) for w in widths.values())
    # Before every version: each row's valid flag, each valid row's group
    # start, tombstone and hybrid time, and the view's planes written.
    nothing = mvcc_resolve.view_bytes(arrays, *read_planes(P, 0))
    assert nothing == n + 10 * valid + writes
    # A padding block adds its valid flags and the view's writes only.
    pad = {k: torch.cat([v, torch.zeros_like(v[:1])])
           for k, v in arrays.items() if k != "cols"}
    pad["cols"] = {cid: {k: torch.cat([v, torch.zeros_like(v[:1])])
                         for k, v in c.items()}
                   for cid, c in arrays["cols"].items()}
    assert mvcc_resolve.view_bytes(pad, *read_planes(P, 0)) - nothing == \
        R * (1 + 2 + sum(2 + w for w in widths.values()))
    # At the newest read point each latest setter's isnull, order and
    # arithmetic planes are read once, beside the walk's flags and expiries.
    planes = read_planes(P, MAX_HT)
    view = mvcc_resolve.resolve_view_plain(arrays, *planes, run["const"])
    setters = sum(int(view["cols"][cid]["set"].sum()) * (1 + w)
                  for cid, w in widths.items())
    assert setters > 0
    assert mvcc_resolve.view_bytes(arrays, *planes) > nothing + setters


# -- long key groups ---------------------------------------------------------

LONG_BLOCKS = 16  # a multiple of K


@pytest.fixture(scope="module", params=[64, 48], ids=["R64", "R48"])
def long_run(request):
    R_ = request.param
    planes = workload.long_group_planes(LONG_BLOCKS * R_, R_, seed=R_)
    schema = workload.make_schema()
    port = DeviceRun.from_reference_planes(planes, R_, "cpu")
    return {"R": R_, "planes": planes, "jax_arrays": jax_arrays(planes),
            "port": port, "const": mvcc_resolve.constant_planes(
                port.B, R_, "cpu"),
            "cid": {c.name: c.col_id for c in schema.value_columns},
            "kinds": {c.col_id: dtype_kind(c.dtype)
                      for c in schema.value_columns}}


def long_groups(planes):
    """(first row, length) of every key group of valid rows, flattened."""
    valid = planes["valid"].reshape(-1)
    R_ = planes["valid"].shape[1]
    starts = planes["group_start"].reshape(-1).copy()
    starts[::R_] = True  # a group never crosses a block
    first = np.flatnonzero(starts & valid)
    ends = np.append(np.flatnonzero(starts), valid.size)
    return first, ends[np.searchsorted(ends, first, side="right")] - first


def long_hts(planes):
    return P.planes_to_u64(planes["ht_hi"], planes["ht_lo"]).astype(
        np.int64).reshape(-1)


def tie_rows(planes):
    """Tombstones whose previous row, in the same group, is a write at the
    same hybrid time."""
    tomb = planes["tomb"].reshape(-1)
    gs = planes["group_start"].reshape(-1)
    ht = long_hts(planes)
    t = np.flatnonzero(tomb[1:] & ~gs[1:]) + 1
    return t[(ht[t - 1] == ht[t]) & ~tomb[t - 1]]


def test_long_group_planes_keep_the_layout(long_run):
    planes, R_ = long_run["planes"], long_run["R"]
    B = LONG_BLOCKS
    valid = planes["valid"]
    assert valid.shape == (B, R_) and planes["group_start"][:, 0].all()
    # Padding only at a block's end, each padding row its own group with
    # zero planes and no expiry.
    assert not (~valid[:, :-1] & valid[:, 1:]).any()
    pad = ~valid
    assert planes["group_start"][pad].all()
    assert not (planes["tomb"] | planes["live"])[pad].any()
    assert not (planes["ht_hi"][pad] | planes["ht_lo"][pad]).any()
    exp_hi, exp_lo = P.scalar_ht_planes(MAX_HT)
    assert (planes["exp_hi"][pad] == exp_hi).all()
    assert (planes["exp_lo"][pad] == exp_lo).all()
    for c in planes["cols"].values():
        assert not (c["set"] & ~valid).any() and not (c["set"] &
                                                      planes["tomb"]).any()
        assert not (c["isnull"] & ~c["set"]).any()
        assert not c["cmp"][~c["set"] | c["isnull"]].any()
        assert not c["arith"][~c["set"] | c["isnull"]].any()
    assert any(c["isnull"].any() for c in planes["cols"].values())
    # Group lengths from the drawn set, groups past one warp step, one
    # filling a block; hybrid times never increase within a group.
    first, length = long_groups(planes)
    allowed = {n for n in workload.LONG_GROUP_LENGTHS + (R_,) if n <= R_}
    assert set(length.tolist()) <= allowed
    assert (length > 32).any() and (length == R_).any()
    assert length.sum() == valid.sum()
    ht = long_hts(planes)
    same_group = ~planes["group_start"].reshape(-1)[1:] & \
        valid.reshape(-1)[1:]
    assert (ht[1:][same_group] <= ht[:-1][same_group]).all()
    # Tombstones, same-hybrid-time writes before them, and TTLs.
    share = planes["tomb"].sum() / valid.sum()
    assert 0.005 < share < 0.05
    assert len(tie_rows(planes)) > 0
    assert (planes["exp_hi"][valid] != exp_hi).any()


def long_read(long_run, which: str) -> int:
    planes = long_run["planes"]
    ht = long_hts(planes)[planes["valid"].reshape(-1)]
    tie = int(long_hts(planes)[tie_rows(planes)[0]])
    return {"newest": int(ht.max()) + 1, "mid": int(np.median(ht)),
            "tie": tie, "before_tie": tie - 1}[which]


@pytest.mark.parametrize("read", ["newest", "mid", "tie", "before_tie"])
def test_long_groups_fold_to_jax_seg_fold(long_run, read):
    R_, kinds, cid = long_run["R"], long_run["kinds"], long_run["cid"]
    read_ht = long_read(long_run, read)
    pred, lit = (cid["d"], "i32", ">="), np.int32(-300_000)

    def sig(scan, flat):
        return scan.ScanSig(
            B=LONG_BLOCKS, R=R_, K=K,
            cols=tuple(scan.ColSig(c, k) for c, k in kinds.items()),
            preds=(scan.PredSig(*pred),),
            aggs=tuple(scan.AggSig(*a) for a in (
                ("count", None, None), ("count", cid["d"], "i32"),
                ("sum", cid["a"], "i64"), ("sum", cid["d"], "i32"),
                ("min", cid["a"], "i64"), ("max", cid["a"], "i64"),
                ("min", cid["d"], "i32"), ("max", cid["d"], "i32"),
                ("sum", cid["c"], "f64"), ("min", cid["c"], "f64"),
                ("max", cid["c"], "f64"))),
            apply_preds=True, flat=flat)

    arrays = long_run["port"].arrays
    assert_view_folds_to_jax(
        long_run["jax_arrays"], sig(j_scan, False), sig(t_scan, True),
        lambda: mvcc_resolve.resolve_view(
            arrays, *read_planes(P, read_ht), long_run["const"]),
        kinds, pred, lit, read_ht, LONG_BLOCKS * R_)


@pytest.mark.parametrize("R", [1, 33, 48, 64, 2048, 2049, 4096])
def test_launch_geometry_tiles_whole_blocks(R):
    """Each block of the kernel stages whole blocks of R rows (so no key
    group crosses a tile) where R fits a tile, the tiles cover every row,
    and the shared memory of a block fits an SM at every column count."""
    n_rows = 7 * R
    for n_cols in (0, 1, 3, mvcc_resolve.MAX_COLS):
        geo = mvcc_resolve.launch_geometry(n_rows, R, n_cols)
        tile = geo["tile_rows"]
        assert 0 < tile <= mvcc_resolve.TILE_MAX
        if R <= mvcc_resolve.TILE_MAX:
            assert tile % R == 0 and tile + R > mvcc_resolve.TILE_MAX
        assert (geo["blocks"] - 1) * tile < n_rows <= geo["blocks"] * tile
        assert geo["smem_bytes"] <= mvcc_resolve.SMEM_PER_SM
        # Each column's set flags (a byte a row) and setters (two).
        assert geo["dynamic_smem_bytes"] >= 3 * n_cols * tile
