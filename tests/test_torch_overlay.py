"""Post-write aggregate scans: the port's delta overlay against the JAX
package's ``cpu`` and ``tpu`` engines.

The three engines take the same rows (``overlay_history``,
``tests/test_overlay.py``'s ``_setup`` shape over the bench table: a
primary run, then waves of writes with 15% DELETEs and 15% NULL writes,
a flush between waves, so that several runs and a live memtable hold
dirty keys), on a multi-version primary (with a key past 32 versions that
a wave makes dirty) and on a flat one. Every spec must give the same
columns and rows as both JAX engines (integers exactly, float sums and
averages within rel 1e-4 / abs 1e-4) and the ``rows_scanned`` of the
``tpu`` engine. Also here: the engine before its first flush, the
incremental delta after a write, a flush that changes the run set, a
batch issued before a write and finished after it, the dirty set too
large for the overlay (served by the row scan over the sources), the
resolve
and fold of planes with whole key groups cleared against the JAX
package's K4 and K3, and the host pieces (``versions_since``,
``iter_entries`` / ``find_versions``, ``RowMaterializer`` /
``Aggregator``) against their JAX counterparts.
"""

import numpy as np
import pytest

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.tpu_engine  # noqa: F401  (registers 'tpu')
import yugabyte_db_tpu_torch.storage as T
from test_torch_data import (JAX, MAX_HT, PORT, assert_same, build_run,
                             build_spec, make_schema, multiversion_rows,
                             overlay_history, read_planes, reference_planes)
from yugabyte_db_tpu.ops import agg_fold as j_agg_fold
from yugabyte_db_tpu.ops import lookback_fold as j_lookback_fold
from yugabyte_db_tpu.ops import scan as j_scan
from yugabyte_db_tpu.ops import seg_fold as j_seg_fold
from yugabyte_db_tpu.storage import cpu_engine as j_cpu_engine
from yugabyte_db_tpu.storage import expr as j_expr
from yugabyte_db_tpu_torch.ops import agg_fold, flat_agg, flat_fold
from yugabyte_db_tpu_torch.ops import mvcc_resolve
from yugabyte_db_tpu_torch.ops import scan as t_scan
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun, dtype_kind
from yugabyte_db_tpu_torch.storage import cpu_engine as t_cpu_engine
from yugabyte_db_tpu_torch.storage import expr as t_expr
from yugabyte_db_tpu_torch.storage import gpu_engine
from yugabyte_db_tpu_torch.utils import planes as P

R = 64
INTS = [("count", None), ("sum", "a"), ("sum", "d"), ("min", "a"),
        ("max", "a"), ("min", "d"), ("max", "d"), ("avg", "a")]  # K1 takes 8
FLOATS = [("count", None), ("sum", "c"), ("min", "c"), ("max", "c"),
          ("avg", "c")]


def make_engines(flat: bool, **kw):
    """The three engines after ``overlay_history``'s base (flushed) and
    waves (flushed between waves, the last one left in the memtable)."""
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jbase, jwaves, ht = overlay_history(JAX, js, flat, **kw)
    pbase, pwaves, _ = overlay_history(PORT, ps, flat, **kw)
    e = {"cpu": J.make_engine("cpu", js),
         "tpu": J.make_engine("tpu", js, {"rows_per_block": R}),
         "gpu": T.make_engine("gpu", ps, {"rows_per_block": R,
                                          "device": "cpu"}),
         "js": js, "ps": ps, "ht": ht}
    for name, base, waves in (("cpu", jbase, jwaves), ("tpu", jbase, jwaves),
                              ("gpu", pbase, pwaves)):
        e[name].apply(base)
        e[name].flush()
        for w, batch in enumerate(waves):
            e[name].apply(batch)
            if w < len(waves) - 1:
                e[name].flush()
    return e


@pytest.fixture(scope="module")
def mv():
    e = make_engines(flat=False, hot=40)
    gpu = e["gpu"]
    assert gpu.runs[0].crun.max_group_versions > 32
    assert len(gpu.runs) == 3 and not gpu.memtable.is_empty
    return e


@pytest.fixture(scope="module")
def flat():
    e = make_engines(flat=True, seed=11)
    assert e["gpu"].runs[0].flat and len(e["gpu"].runs) == 3
    return e


def key_of(side, schema, k, r):
    return schema.encode_primary_key(
        {"k": k, "r": r}, side.partition.compute_hash_code(schema, {"k": k}))


def cases(e):
    """(label, spec keyword arguments) of every case."""
    ht = e["ht"]
    lo, hi = sorted(key_of(PORT, e["ps"], k, 0) for k in ("k0050", "k0200"))
    out = [(f"read_{name}", dict(read_ht=rd, aggregates=INTS))
           for name, rd in (("1", 1), ("third", ht // 3), ("half", ht // 2),
                            ("ht", ht), ("max", MAX_HT))]
    out += [
        ("floats", dict(read_ht=MAX_HT, aggregates=FLOATS,
                        predicates=[("c", ">=", 0.0)])),
        ("d_ge", dict(read_ht=MAX_HT, aggregates=INTS,
                      predicates=[("d", ">=", 0)])),
        ("counts", dict(read_ht=ht // 2, aggregates=[
            ("count", "d"), ("count", "a"), ("avg", "d")])),
        ("two_preds", dict(read_ht=ht, aggregates=INTS,
                           predicates=[("a", "<", 0), ("d", "!=", 3)])),
        ("bounded", dict(read_ht=ht // 2, aggregates=INTS, lower=lo,
                         upper=hi)),
        ("bounded_pred", dict(read_ht=MAX_HT, aggregates=INTS, lower=lo,
                              predicates=[("d", "<", 100_000)])),
    ]
    return out


def check_all(e, kws, label=""):
    """Each spec alone on the gpu engine equals both JAX engines."""
    for lab, kw in kws:
        got = e["gpu"].scan(build_spec(T, kw))
        assert_same(e["tpu"].scan(build_spec(J, kw)), got, label + lab)
        assert_same(e["cpu"].scan(build_spec(J, kw)), got, label + lab,
                    scanned=False)


@pytest.mark.parametrize("primary", ["mv", "flat"])
def test_overlay_specs_match_cpu_and_tpu(primary, request):
    e = request.getfixturevalue(primary)
    gpu = e["gpu"]
    routes = {lab: gpu._plan_scan(build_spec(T, kw))
              for lab, kw in cases(e)}
    assert all(p.overlay is not None for p in routes.values())
    prefix = "" if primary == "flat" else "mv_"
    assert {p.route for p in routes.values()} == {prefix + "kernel",
                                                  prefix + "flat"}
    assert routes["floats"].route == prefix + "flat"
    state = gpu._overlay_cache[3]
    masked = state.masked.dev.arrays["valid"]
    plain = gpu.runs[0].dev.arrays["valid"]
    assert int((plain & ~masked).sum()) == state.idx.size > 0
    assert not (masked & ~plain).any()
    if primary == "mv":  # the hot key's whole long group is masked
        start, own = gpu.runs[0].crun.key_rows(key_of(PORT, e["ps"],
                                                      "k0000", 0))
        assert len(own) > 32
        assert set(range(start, start + len(own))) <= set(state.idx.tolist())
    check_all(e, cases(e))


def test_a_batch_mixes_overlay_and_single_run_specs(mv, monkeypatch):
    """Specs whose range touches the primary only take the plain run;
    the others the masked one. One batch, every spec equal to both JAX
    engines; the overlay's same-signature specs share one K1 call, and a
    masked multi-version run is resolved once per view key."""
    e, gpu = mv, mv["gpu"]
    keys = sorted(gpu.memtable.scan_keys(b"", b""))
    cut = min([t.crun.min_key for t in gpu.runs[1:]] + keys[:1])
    assert gpu.runs[0].crun.min_key < cut
    kws = cases(e)
    kws += [(f"primary_only_{rd}", dict(read_ht=rd, aggregates=INTS,
                                        upper=cut))
            for rd in (e["ht"] // 2, MAX_HT)]
    kws += [(f"lit_{lo}", dict(read_ht=MAX_HT, aggregates=INTS,
                               predicates=[("d", ">=", lo)]))
            for lo in (-500_000, 500_000)]
    preps = [gpu._plan_scan(build_spec(T, kw)) for _l, kw in kws]
    assert [p.overlay is None for p in preps] == \
        [lab.startswith("primary_only") for lab, _kw in kws]
    calls, resolves = [], []
    fold, resolve = flat_agg.flat_aggregate, mvcc_resolve.resolve_view

    def counted_fold(plan, table, params):
        calls.append(params.shape[0])
        return fold(plan, table, params)

    def counted_resolve(run, *args):
        resolves.append(run["valid"])
        return resolve(run, *args)

    monkeypatch.setattr(flat_agg, "flat_aggregate", counted_fold)
    monkeypatch.setattr(mvcc_resolve, "resolve_view", counted_resolve)
    masked = gpu._overlay_cache[3].masked
    gpu.runs[0].drop_view()
    masked.drop_view()
    got = gpu.scan_batch([build_spec(T, kw) for _l, kw in kws])
    views = {(id(p.trun), p.view_key) for p in preps}
    assert len(resolves) == len(views) < len(kws)
    assert len(calls) < len(kws) - 1
    assert any(v is masked.dev.arrays["valid"] for v in resolves)
    assert any(v is gpu.runs[0].dev.arrays["valid"] for v in resolves)
    # One view of the run is alive: the last one made, run or masked.
    assert (gpu.runs[0].held_view() is None) != \
        (masked.held_view() is None)
    for (lab, kw), g in zip(kws, got):
        assert_same(e["tpu"].scan(build_spec(J, kw)), g, lab)


@pytest.mark.parametrize("primary", ["mv", "flat"])
def test_writes_and_flushes_after_the_first_scan(primary):
    """A write after the first scan advances the overlay by the memtable's
    delta (copy-on-write: the old state is left as it was); a batch
    issued before the write and finished after it keeps the old answer; a
    flush changes the run set and rebuilds it; a memtable without its
    log rebuilds it too."""
    e = make_engines(flat=primary == "flat", seed=13, hot=0 if
                     primary == "flat" else 35)
    gpu, ht = e["gpu"], e["ht"]
    kws = cases(e)
    check_all(e, kws, "first ")
    old = gpu._overlay_cache[3]
    old_rows, old_valid = list(old.rows), old.masked.dev.arrays["valid"]
    old_copy = old_valid.clone()
    cid = {c.name: c.col_id for c in e["ps"].value_columns}
    late = dict(read_ht=MAX_HT, aggregates=INTS)
    want_before = e["tpu"].scan(build_spec(J, late))
    pending = gpu.scan_batch_async([build_spec(T, late)])

    def write(rows_of):
        for name, side in (("cpu", JAX), ("tpu", JAX), ("gpu", PORT)):
            schema = e["ps"] if side is PORT else e["js"]
            e[name].apply(rows_of(side, schema))

    # A dirty key, a clean primary key and a key no run holds.
    write(lambda side, schema: [
        side.row_version.RowVersion(key_of(side, schema, k, r), ht=ht + 1 + i,
                                    columns={cid["d"]: 424242 + i})
        for i, (k, r) in enumerate([("k0001", 0), ("k0002", 2),
                                    ("zz-new", 3)])])
    assert_same(want_before, pending.finish()[0], "issued before the write")
    check_all(e, kws + [("late", late)], "after a write ")
    new = gpu._overlay_cache[3]
    assert new is not old and new.mem_count == old.mem_count + 3
    assert old.rows == old_rows and len(new.rows) > len(old.rows)
    assert old.masked.dev.arrays["valid"] is old_valid
    assert torch_equal(old_valid, old_copy)
    # A memtable without its log: the overlay is built from scratch.
    gpu.memtable._log = None
    write(lambda side, schema: [side.row_version.RowVersion(
        key_of(side, schema, "k0003", 2), ht=ht + 10, tombstone=True)])
    check_all(e, kws + [("late", late)], "rebuilt ")
    assert gpu._overlay_cache[3].mem_count == gpu.memtable.num_versions
    for name in ("cpu", "tpu", "gpu"):
        e[name].flush()
    assert gpu._overlay_cache is None and len(gpu.runs) == 4
    check_all(e, kws + [("late", late)], "after a flush ")


def torch_equal(a, b) -> bool:
    return bool((a == b).all())


def test_engine_before_its_first_flush():
    """No run yet: the memtable alone is folded on the host, as the JAX
    engines fold it (``rows_scanned``: keys examined)."""
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jbase, jwaves, ht = overlay_history(JAX, js, False, nbase=400, waves=2)
    pbase, pwaves, _ = overlay_history(PORT, ps, False, nbase=400, waves=2)
    e = {"cpu": J.make_engine("cpu", js),
         "tpu": J.make_engine("tpu", js, {"rows_per_block": R}),
         "gpu": T.make_engine("gpu", ps, {"rows_per_block": R,
                                          "device": "cpu"}),
         "js": js, "ps": ps, "ht": ht}
    for name, rows in (("cpu", jbase + jwaves[0] + jwaves[1]),
                       ("tpu", jbase + jwaves[0] + jwaves[1]),
                       ("gpu", pbase + pwaves[0] + pwaves[1])):
        e[name].apply(rows)
    kws = cases(e)
    check_all(e, kws)
    assert e["gpu"].memtable_scans == len(kws)
    # A key-column predicate over the memtable: the row scan.
    kw = dict(read_ht=MAX_HT, aggregates=[("count", None)],
              predicates=[("r", ">=", 3)])
    got = e["gpu"].scan(build_spec(T, kw))
    assert_same(e["tpu"].scan(build_spec(J, kw)), got, "key predicate")
    assert_same(e["cpu"].scan(build_spec(J, kw)), got, "key predicate",
                scanned=False)


def test_a_dirty_set_past_half_the_primary_raises():
    """``tests/test_overlay.py::test_overlay_large_dirty_set_falls_back``'s
    shape: the overlay declines it, and the port serves it on its row
    scan over the sources (K9's candidates) as the JAX engines serve it
    on theirs."""
    e = make_engines(flat=False, seed=19, nbase=300, nkeys=60, waves=2,
                     per_wave=400)
    kw = dict(read_ht=MAX_HT, aggregates=INTS)
    got = e["gpu"].scan(build_spec(T, kw))
    assert got.rows
    assert_same(e["tpu"].scan(build_spec(J, kw)), got, "past half")
    assert_same(e["cpu"].scan(build_spec(J, kw)), got, "past half",
                scanned=False)
    assert e["gpu"]._overlay_cache[3] is None


# -- the folds over planes with whole key groups cleared --------------------

K = 8


def cleared_run(**rows_kw):
    """A multi-version history's planes (the JAX package's unencoded
    ``DeviceRun.arrays``) with the valid flags of whole key groups
    cleared: one in mid-block, one at a block's start, every group of
    one block, and the longest group (past 32 versions where there is
    one)."""
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    rows, max_ht = multiversion_rows(JAX, js, **rows_kw)
    crun = build_run(JAX, js, rows, R)
    planes = reference_planes(crun, K)
    valid = planes["valid"].reshape(-1).copy()
    starts = planes["group_start"].reshape(-1) & valid
    first = np.flatnonzero(starts)
    ends = np.append(first[1:], valid.size)
    lengths = np.minimum(ends, (first // R + 1) * R) - first
    pick = set()
    mid = first[(first % R > R // 4) & (first % R < R // 2)]
    pick.add(int(mid[0]))
    pick.add(int(first[first % R == 0][1]))
    pick |= {int(f) for f in first if f // R == 2}
    pick.add(int(first[np.argmax(lengths)]))
    for f in pick:
        g = int(np.searchsorted(first, f))
        valid[f:f + lengths[g]] = False
    planes["valid"] = valid.reshape(planes["valid"].shape)
    return {"crun": crun, "planes": planes, "max_ht": max_ht,
            "longest": int(lengths.max()), "cleared": len(pick),
            "cid": {c.name: c.col_id for c in ps.value_columns},
            "kinds": {c.col_id: dtype_kind(c.dtype)
                      for c in ps.value_columns}}


def fold_sigs(scan, run, **kw):
    cid = run["cid"]
    a, c, d = cid["a"], cid["c"], cid["d"]
    aggs = [("count", None, None), ("count", d, "i32"), ("sum", a, "i64"),
            ("sum", d, "i32"), ("min", a, "i64"), ("max", a, "i64"),
            ("min", d, "i32"), ("max", d, "i32"), ("sum", c, "f64")]
    return scan.ScanSig(
        B=run["planes"]["valid"].shape[0], R=R, K=K,
        cols=tuple(scan.ColSig(col, kind)
                   for col, kind in run["kinds"].items()),
        preds=(scan.PredSig(d, "i32", ">="),),
        aggs=tuple(scan.AggSig(*x) for x in aggs), apply_preds=True, **kw)


def folds(run, jax_fn, jsig, read_ht):
    """(JAX finalized values, port finalized values), each with the
    scanned count first: the JAX fold on the planes, and the port's
    resolved view folded by ``flat_fold``."""
    import jax.numpy as jnp

    planes = run["planes"]
    arrays = {k: ({c: {n: jnp.asarray(x) for n, x in v2.items()}
                   for c, v2 in v.items()} if k == "cols" else jnp.asarray(v))
              for k, v in planes.items()}
    lits = (agg_fold.pred_literal_host("i32", -300_000),)
    args = (0, run["crun"].total_rows(), *read_planes(P, read_ht), lits)
    ji, jf = jax_fn(jsig)(arrays, *args)
    port = DeviceRun.from_reference_planes(planes, R, "cpu")
    view = mvcc_resolve.resolve_view_plain(
        port.arrays, *read_planes(P, read_ht),
        mvcc_resolve.constant_planes(port.B, R, "cpu"))
    tsig = fold_sigs(t_scan, run, flat=True)
    ti, tf = flat_fold.compiled_flat_aggregate(tsig)(view, *args)
    out = []
    for mod, sig, iv, fv in ((j_agg_fold, jsig, ji, jf),
                             (agg_fold, tsig, ti, tf)):
        acc, scanned = mod.unpack(sig.aggs, np.asarray(iv), np.asarray(fv))
        out.append([scanned] + [mod.finalize(ag, x, ag.fn)
                                for ag, x in zip(sig.aggs, acc)])
    # A cleared group's first row is an invalid view row.
    first = (planes["group_start"] & ~planes["valid"]).reshape(-1)
    assert not view["valid"].reshape(-1)[first].any()
    return out


@pytest.mark.parametrize("read", ["half", "newest"])
def test_cleared_groups_fold_as_jax_seg_fold(read):
    run = cleared_run(seed=4, hot=0.045)
    assert run["longest"] > 32 and run["cleared"] > 4
    rd = run["max_ht"] // 2 if read == "half" else MAX_HT
    want, got = folds(run, j_seg_fold.compiled_seg_aggregate,
                      fold_sigs(j_scan, run, flat=False), rd)
    assert want[0] > 0
    assert got[:-1] == want[:-1]
    assert got[-1] == pytest.approx(want[-1], rel=1e-5, abs=1e-3)


def test_cleared_groups_fold_as_jax_lookback_fold():
    run = cleared_run(n=300, nkeys=150, seed=6)
    W = 1 << (run["crun"].max_group_versions - 1).bit_length()
    jsig = fold_sigs(j_scan, run, flat=False, lookback=W)
    assert j_lookback_fold.supports(jsig)
    want, got = folds(run, j_lookback_fold.compiled_lookback_aggregate, jsig,
                      MAX_HT)
    assert want[0] > 0
    assert got[:-1] == want[:-1]
    assert got[-1] == pytest.approx(want[-1], rel=1e-5, abs=1e-3)


# -- host pieces against their JAX counterparts ------------------------------

def test_versions_since_matches_jax():
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jbase, jwaves, _ = overlay_history(JAX, js, False, nbase=100, waves=2)
    pbase, pwaves, _ = overlay_history(PORT, ps, False, nbase=100, waves=2)
    jm, pm = JAX.memtable.MemTable(), PORT.memtable.MemTable()
    for jrows, prows in ((jbase, pbase), (jwaves[0], pwaves[0])):
        jm.apply(jrows)
        pm.apply(prows)
    for n in (0, 1, len(pbase), pm.num_versions, pm.num_versions + 5):
        want = [(r.key, r.ht) for r in jm.versions_since(n)]
        assert [(r.key, r.ht) for r in pm.versions_since(n)] == want, n
    pm._log = jm._log = None
    assert pm.versions_since(0) is None is jm.versions_since(0)


def test_iter_entries_and_find_versions_match_jax():
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jrun = build_run(JAX, js, multiversion_rows(JAX, js, seed=8)[0], R)
    prun = build_run(PORT, ps, multiversion_rows(PORT, ps, seed=8)[0], R)

    def fields(versions):
        return [(v.key, v.ht, v.write_id, v.tombstone) for v in versions]

    want = [(k, fields(v)) for k, v in jrun.iter_entries()]
    assert [(k, fields(v)) for k, v in prun.iter_entries()] == want
    probes = [k for k, _v in want[::7]] + [b"", b"\xff" * 40,
                                           want[3][0] + b"\x00"]
    for key in probes:
        assert fields(prun.find_versions(key)) == \
            fields(jrun.find_versions(key))
    start, own = prun.key_rows(want[5][0])
    assert fields(own) == want[5][1]
    b, r = divmod(start, R)
    assert prun.row_keys[b][r] == want[5][0]


def test_row_materializer_and_aggregator_match_jax():
    js, ps = make_schema(JAX, "bench"), make_schema(PORT, "bench")
    jrows, ht = multiversion_rows(JAX, js, seed=9)
    prows, _ = multiversion_rows(PORT, ps, seed=9)
    jm, pm = JAX.memtable.MemTable(), PORT.memtable.MemTable()
    jm.apply(jrows)
    pm.apply(prows)
    jmat = j_cpu_engine.RowMaterializer(js)
    tmat = t_cpu_engine.RowMaterializer(ps)
    aggs = [("count", None), ("count", "c"), ("sum", "a"), ("avg", "d"),
            ("min", "c"), ("max", "a"), ("max", "r"), ("min", "k")]
    preds = [("d", ">=", -500_000), ("r", "<", 5)]
    for rd in (ht // 2, MAX_HT):
        specs = {}
        for S, side in ((J, "jax"), (T, "port")):
            specs[side] = build_spec(S, dict(read_ht=rd, aggregates=aggs,
                                             predicates=preds))
        out = {}
        for side, mem, mat, mod in (
                ("jax", jm, jmat, j_cpu_engine),
                ("port", pm, tmat, t_cpu_engine)):
            spec = specs[side]
            agg = mod.Aggregator(spec.aggregates, [])
            seen = []
            for key in mem.scan_keys(b"", b""):
                merged = mem.merged(key, rd)
                kv = mat.key_values(key)
                seen.append((kv, [mat.value(c, kv, merged)
                                  for c in ("k", "r", "a", "c", "d")],
                             merged.exists and mat.matches(spec, kv,
                                                           merged)))
                if seen[-1][2]:
                    agg.add(lambda n, kv=kv, m=merged: mat.value(n, kv, m))
            out[side] = (seen, agg.column_names(), agg.results())
        assert out["port"][0] == out["jax"][0]
        assert out["port"][1] == out["jax"][1]
        (want,), (got,) = out["jax"][2], out["port"][2]
        assert got[:3] + got[4:] == want[:3] + want[4:]
        assert got[3] == pytest.approx(want[3], rel=1e-12)
    # Expression aggregates under GROUP BY: the expression evaluated in
    # Python integers, NULL contagious, as the JAX Aggregator does.
    out = {}
    for side, mem, mat, mod, X, S in (
            ("jax", jm, jmat, j_cpu_engine, j_expr, J),
            ("port", pm, tmat, t_cpu_engine, t_expr, T)):
        tree = X.BinOp("*", X.Col("a"), X.BinOp("-", X.Const(100),
                                                X.Col("d")))
        agg = mod.Aggregator([
            S.AggSpec("sum", None, expr=tree, label="s"),
            S.AggSpec("count", None, expr=tree),
            S.AggSpec("max", None, expr=X.BinOp("+", X.Col("d"),
                                                X.Col("r"))),
            S.AggSpec("count", None)], ["r"])
        for key in mem.scan_keys(b"", b""):
            merged = mem.merged(key, MAX_HT)
            kv = mat.key_values(key)
            if merged.exists:
                agg.add(lambda n, kv=kv, m=merged: mat.value(n, kv, m))
        out[side] = (agg.column_names(), agg.results())
    assert out["port"] == out["jax"]
    # A NULL d leaves its row out of count(expr) but not of count(*).
    assert any(r[2] < r[4] for r in out["port"][1])


def test_scatter_invalid_leaves_its_source():
    valid = DeviceRun.from_reference_planes(
        reference_planes(build_run(
            JAX, make_schema(JAX, "bench"),
            multiversion_rows(JAX, make_schema(JAX, "bench"), seed=2)[0],
            R), K), R, "cpu").arrays["valid"]
    before = valid.clone()
    idx = np.array([0, 5, R + 3, valid.numel() - 1], np.int64)
    out = gpu_engine.scatter_invalid(valid, idx)
    assert bool((valid == before).all())
    flat = before.reshape(-1).clone()
    flat[idx] = False
    assert bool((out.reshape(-1) == flat).all())
    assert gpu_engine.scatter_invalid(valid, np.zeros(0, np.int64)).equal(
        valid)


def test_update_waves_match_the_cpu_engine():
    """``workload.make_wave_rows``: its mix, and four waves over
    ``make_rows``' keys (the first three flushed) served through the
    overlay as the JAX ``cpu`` engine serves them, between the waves and
    after them."""
    from yugabyte_db_tpu_torch import workload

    ps, js = workload.make_schema(), make_schema(JAX, "bench")
    rows, ht = workload.make_rows(ps, 3000, seed=7)
    gpu = T.make_engine("gpu", ps, {"rows_per_block": 512, "device": "cpu"})
    cpu = J.make_engine("cpu", js)

    def to_jax(rs):
        return [JAX.row_version.RowVersion(
            r.key, ht=r.ht, tombstone=r.tombstone, liveness=r.liveness,
            columns=dict(r.columns), expire_ht=r.expire_ht,
            write_id=r.write_id) for r in rs]

    ends, updates = [], []
    for e, rs in ((gpu, rows), (cpu, to_jax(rows))):
        e.apply(rs)
        e.flush()
    for w in range(4):
        wave, ht = workload.make_wave_rows(ps, 3000, 400, ht, seed=w)
        assert [r.ht for r in wave] == list(range(ht - 399, ht + 1))
        updates += wave
        ends.append(ht)
        for e, rs in ((gpu, wave), (cpu, to_jax(wave))):
            e.apply(rs)
            if w < 3:
                e.flush()
    d = ps.value_columns[-1].col_id
    tombs = sum(u.tombstone for u in updates)
    nulls = sum(u.columns == {d: None} for u in updates)
    assert all(u.tombstone or (list(u.columns) == [d] and not u.liveness)
               for u in updates)
    assert 0.01 < tombs / len(updates) < 0.03
    assert 0.01 < nulls / len(updates) < 0.03
    assert len(gpu.runs) == 4 and gpu.memtable.num_versions == 400
    for rd in (ends[1] + 1, ends[3] + 1):
        for kw in (dict(read_ht=rd, aggregates=[
                ("count", None), ("sum", "a"), ("min", "a"), ("max", "a"),
                ("sum", "d")], predicates=[("d", ">=", -500_000)]),
                dict(read_ht=rd, aggregates=[("count", "c"), ("avg", "c"),
                                             ("max", "c")])):
            assert gpu._plan_scan(build_spec(T, kw)).overlay is not None
            assert_same(cpu.scan(build_spec(J, kw)),
                        gpu.scan(build_spec(T, kw)), rd, scanned=False)
