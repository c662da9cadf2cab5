"""The flat-run aggregate fold (K1): the port against the Pallas kernel.

The port's ``ops.flat_agg`` on CPU tensors (its plain PyTorch version, the
arithmetic of ``csrc/flat_agg.cu``) against the JAX package's
``pallas_agg.compiled_flat_aggregate`` in interpret mode, as
``tests/test_pallas_agg.py`` runs it, on the same plane bytes and the same
parameter rows. ``(count, scanned, values)`` must be exactly equal; both
slots 0 and 1 are held (slot 1 counts existing rows before predicates).
"""

import numpy as np
import pytest
import torch

from test_torch_data import (JAX, PORT, build_run, flat_rows, make_schema,
                             read_planes, reference_planes)
from yugabyte_db_tpu.ops import pallas_agg
from yugabyte_db_tpu_torch.ops import flat_agg
from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
from yugabyte_db_tpu_torch.ops.scan import AggSig, ColSig, PredSig, ScanSig
from yugabyte_db_tpu_torch.utils import planes as P

R = 128
N_KEYS = 1500
OPS = ("=", "!=", "<", "<=", ">", ">=")


@pytest.fixture(scope="module")
def run():
    js, ps = make_schema(JAX, "pallas"), make_schema(PORT, "pallas")
    rows, max_ht = flat_rows(JAX, js, N_KEYS, seed=21)
    crun = build_run(JAX, js, rows, R)
    planes = reference_planes(crun, pallas_agg.BLOCKS_PER_STEP)
    cid = {c.name: c.col_id for c in ps.value_columns}
    # A stored value of each column on a row with no TTL, so '=' matches.
    ok = planes["exp_hi"] == planes["exp_hi"].max()
    for c in (cid["a"], cid["d"]):
        ok = ok & planes["cols"][c]["set"] & ~planes["cols"][c]["isnull"]
    ok = ok.reshape(-1)
    hit = int(np.flatnonzero(ok)[100])
    lits = {"i64": planes["cols"][cid["a"]]["cmp"].reshape(-1, 2)[hit],
            "i32": planes["cols"][cid["d"]]["cmp"].reshape(-1)[hit]}
    return {
        "cid": cid, "crun": crun, "planes": planes, "max_ht": max_ht,
        "jax_arrays": jax_arrays(planes),
        "port": DeviceRun.from_reference_planes(planes, R, "cpu"),
        "lits": lits,
    }


def jax_arrays(planes):
    import jax.numpy as jnp

    return {k: ({c: {n: jnp.asarray(a) for n, a in e.items()}
                 for c, e in v.items()} if k == "cols" else jnp.asarray(v))
            for k, v in planes.items()}


def all_aggs(cid):
    a, d = cid["a"], cid["d"]
    return (AggSig("count", None, None), AggSig("count", d, "i32"),
            AggSig("sum", a, "i64"), AggSig("sum", d, "i32"),
            AggSig("min", a, "i64"), AggSig("max", a, "i64"),
            AggSig("min", d, "i32"), AggSig("max", d, "i32"))


def pallas_fold(run, aggs, preds, param_rows):
    """combine_partials of the Pallas kernel, one call per param row."""
    cid = run["cid"]
    col_order = ((cid["a"], True), (cid["d"], False))
    B = run["planes"]["valid"].shape[0]
    fn = pallas_agg.compiled_flat_aggregate(B, R, aggs, preds, col_order,
                                            interpret=True)
    tensors = pallas_agg.gather_tensors(run["jax_arrays"], col_order)
    return [pallas_agg.combine_partials(
        np.asarray(fn(tensors, np.array(p, np.int32))), aggs)
        for p in param_rows]


def port_fold(run, aggs, preds, param_rows):
    cid = run["cid"]
    plan = flat_agg.make_plan(aggs, preds, (cid["a"], cid["d"]))
    table = plan.plane_table(run["port"].arrays)
    partials = flat_agg.flat_aggregate(
        plan, table, torch.tensor(param_rows, dtype=torch.int32))
    assert flat_agg.flat_aggregate.launches == 0  # CPU: the plain version
    folded = flat_agg.fold_partials(plan, partials).numpy()
    return [plan.combine(row) for row in folded]


def params(run, aggs, preds, lo, hi, read_ht, lits=()):
    cid = run["cid"]
    plan = flat_agg.make_plan(aggs, preds, (cid["a"], cid["d"]))
    return plan.param_row(lo, hi, read_planes(P, read_ht), lits)


def check_same(run, aggs, preds, param_rows):
    want = pallas_fold(run, aggs, preds, param_rows)
    got = port_fold(run, aggs, preds, param_rows)
    assert [(c, s, list(v)) for c, s, v in got] == \
        [(c, s, list(v)) for c, s, v in want]
    return got


@pytest.mark.parametrize("kind", ["i32", "i64"])
@pytest.mark.parametrize("op", OPS)
def test_predicate_ops_match_pallas(run, op, kind):
    cid = run["cid"]
    col = cid["d"] if kind == "i32" else cid["a"]
    preds = (PredSig(col, kind, op),)
    aggs = all_aggs(cid)
    total = run["crun"].total_rows()
    (count, scanned, vals), = check_same(
        run, aggs, preds,
        [params(run, aggs, preds, 0, total, run["max_ht"] + 1,
                [run["lits"][kind]])])
    assert 0 < count < scanned


@pytest.mark.parametrize("read", ["latest", "mid_history", "before_all"])
@pytest.mark.parametrize("bounds", ["full", "middle", "empty"])
def test_row_bounds_and_read_points_match_pallas(run, bounds, read):
    cid = run["cid"]
    total = run["crun"].total_rows()
    lo, hi = {"full": (0, total), "middle": (total // 4, total // 2 + 3),
              "empty": (total // 2, total // 2)}[bounds]
    read_ht = {"latest": run["max_ht"] + 1,
               "mid_history": (100 + run["max_ht"]) // 2,
               "before_all": 50}[read]
    aggs = all_aggs(cid)
    check_same(run, aggs, (), [params(run, aggs, (), lo, hi, read_ht)])


def test_count_of_each_column_and_two_predicates_match_pallas(run):
    cid = run["cid"]
    aggs = (AggSig("count", cid["a"], "i64"), AggSig("count", None, None),
            AggSig("sum", cid["d"], "i32"), AggSig("max", cid["a"], "i64"))
    preds = (PredSig(cid["d"], "i32", ">="), PredSig(cid["a"], "i64", "<"))
    lits = [np.int32(-200_000),
            np.array(P.i64_to_ordered_planes(np.array([10**13]))).ravel()]
    check_same(run, aggs, preds,
               [params(run, aggs, preds, 0, run["crun"].total_rows(),
                       run["max_ht"] + 1, lits)])


def test_spec_batch_matches_per_spec_pallas(run):
    """N parameter rows in one call: each row equals its own Pallas call."""
    cid = run["cid"]
    aggs = all_aggs(cid)
    preds = (PredSig(cid["d"], "i32", ">="),)
    total = run["crun"].total_rows()
    rows = [params(run, aggs, preds, lo, hi, rd, [np.int32(lit)])
            for lo, hi, rd, lit in [
                (0, total, run["max_ht"] + 1, -500_000),
                (0, total, run["max_ht"] + 1, 250_000),
                (total // 3, total, run["max_ht"] + 1, -10**6),
                (0, total // 2, (100 + run["max_ht"]) // 2, 0),
                (7, 7, run["max_ht"] + 1, 0)]]
    got = check_same(run, aggs, preds, rows)
    assert len({g[0] for g in got}) == len(rows)


def test_eligibility_and_plan_layout():
    cols = (ColSig(1, "i64"), ColSig(2, "i32"), ColSig(3, "f64"))

    def sig(aggs, preds=(), flat=True):
        return ScanSig(B=8, R=R, K=8, cols=cols, preds=preds, aggs=aggs,
                       apply_preds=True, flat=flat)

    cnt = AggSig("count", None, None)
    assert flat_agg.eligible(sig((cnt, AggSig("count", 3, "f64"),
                                  AggSig("sum", 1, "i64"))))
    assert not flat_agg.eligible(sig((cnt,), flat=False))
    assert not flat_agg.eligible(sig((AggSig("sum", 3, "f64"),)))
    assert not flat_agg.eligible(sig((cnt,), (PredSig(3, "f64", "<"),)))
    assert not flat_agg.eligible(sig((cnt,) * (flat_agg.MAX_AGGS + 1)))
    plan = flat_agg.make_plan((cnt, AggSig("sum", 1, "i64"),
                               AggSig("max", 2, "i32")),
                              (PredSig(1, "i64", "="),), (1, 2, 3))
    assert plan.n_out == 2 + 1 + 5 + 3
    assert plan.n_params == flat_agg.PARAM_HEAD + 2
    assert plan.cmp_cols == {1, 2}


def test_wrapper_refuses_what_the_kernel_does_not_take(run):
    cid = run["cid"]
    aggs = all_aggs(cid)
    plan = flat_agg.make_plan(aggs, (), (cid["a"], cid["d"]))
    table = plan.plane_table(run["port"].arrays)
    good = torch.tensor([params(run, aggs, (), 0, 10, 10**6)],
                        dtype=torch.int32)
    with pytest.raises(ValueError):
        flat_agg.flat_aggregate(plan, table, good.to(torch.int64))
    with pytest.raises(ValueError):
        flat_agg.flat_aggregate(plan, table[:-1], good)
    bad = list(table)
    bad[4] = bad[4].to(torch.int32)  # valid plane must stay bool
    with pytest.raises(ValueError):
        flat_agg.flat_aggregate(plan, bad, good)
    bad = list(table)
    bad[0] = bad[0].t()
    with pytest.raises(ValueError):
        flat_agg.flat_aggregate(plan, bad, good)


# -- the redesigned kernel's launch shape, wrapper checks and edges ------------

I32_LO, I32_HI = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)
I64_LO, I64_HI = int(np.iinfo(np.int64).min), int(np.iinfo(np.int64).max)


@pytest.mark.parametrize("n_cols,cmp_words,n_preds,n_out", [
    (1, 0, 0, 3),                                         # COUNT(*) only
    (3, 3, 1, 19),                                        # headline spec
    (flat_agg.MAX_COLS, 2 * flat_agg.MAX_COLS, flat_agg.MAX_PREDS,
     2 + 5 * flat_agg.MAX_AGGS),                          # the maxima
])
def test_launch_geometry_fits_every_spec_count(n_cols, cmp_words, n_preds,
                                               n_out):
    """For N = 1..65535 specs: every spec in exactly one chunk, no more
    than 65535 chunks (grid.y), shared memory within the block limit."""
    for n_rows in (0, 4, 1_001_472, (1 << 31) - 4):
        tiles = max(1, -(-n_rows // flat_agg.TILE_ROWS))
        for n in range(1, 65536):
            g = flat_agg.launch_geometry(n, n_rows, n_cols, cmp_words,
                                         n_preds, n_out, 132)
            assert g.tile_rows == flat_agg.TILE_ROWS
            assert 1 <= g.spec_chunk <= flat_agg.SPEC_CHUNK
            assert g.n_chunks <= 65535
            assert (g.n_chunks - 1) * g.spec_chunk < n <= \
                g.n_chunks * g.spec_chunk
            assert g.smem_bytes <= flat_agg.SMEM_LIMIT
            assert 1 <= g.grid_x <= min(tiles, flat_agg.BLOCKS_PER_SM * 132)
            if n_rows:  # shape depends on N only through the chunk
                break
    for bad in (0, 65536):
        with pytest.raises(ValueError):
            flat_agg.launch_geometry(bad, 1024, n_cols, cmp_words, n_preds,
                                     n_out, 132)


@pytest.mark.parametrize("plane", [0, 4, 9])  # ht_hi, valid, a's cmp
def test_wrapper_refuses_a_plane_off_the_16_byte_alignment(run, plane):
    cid = run["cid"]
    aggs = all_aggs(cid)
    plan = flat_agg.make_plan(aggs, (), (cid["a"], cid["d"]))
    table = list(plan.plane_table(run["port"].arrays))
    good = torch.tensor([params(run, aggs, (), 0, 10, 10**6)],
                        dtype=torch.int32)
    t = table[plane]
    # Right shape, dtype and contiguity, one element past an aligned base.
    off = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % flat_agg.ALIGN
    want = flat_agg.flat_aggregate(plan, table, good)
    table[plane] = off
    # The CUDA branch checks the table just before its launch; the plain
    # version on CPU tensors needs no alignment and serves it.
    with pytest.raises(ValueError, match="aligned"):
        flat_agg.check_launchable(table)
    assert torch.equal(flat_agg.flat_aggregate(plan, table, good), want)


def test_wrapper_refuses_a_row_count_off_the_vector_width():
    plan = flat_agg.make_plan((AggSig("count", None, None),), (), (1,))
    B, R = 1, flat_agg.VEC + 2
    table = [torch.zeros((B, R), dtype=torch.int32) for _ in range(4)]
    table += [torch.zeros((B, R), dtype=torch.bool) for _ in range(5)]
    table.append(torch.zeros((B, R, 1), dtype=torch.int32))
    p = torch.tensor([plan.param_row(0, R, (0, 0, 0, 0), ())],
                     dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        flat_agg.check_launchable(table)
    assert flat_agg.flat_aggregate(plan, table, p).shape == (1, 1, 3)


@pytest.fixture(scope="module")
def extreme_run(run):
    """The module's run with ~2% of the non-NULL a and d values moved to
    their type's extremes (both sides read the same bytes)."""
    planes = {k: (v if k == "cols" else v.copy()) for k, v in run["planes"].items()}
    cid = run["cid"]
    planes["cols"] = {c: {n: a.copy() for n, a in e.items()}
                      for c, e in run["planes"]["cols"].items()}
    rng = np.random.default_rng(33)
    for c, lo, hi in ((cid["a"], I64_LO, I64_HI), (cid["d"], I32_LO, I32_HI)):
        col = planes["cols"][c]
        keep = (col["set"] & ~col["isnull"]).reshape(-1)
        pick = np.flatnonzero(keep & (rng.random(keep.size) < 0.02))
        values = np.where(rng.random(pick.size) < 0.5, lo, hi)
        cmp = col["cmp"].reshape(-1, col["cmp"].shape[-1])
        if c == cid["a"]:
            h, l = P.i64_to_ordered_planes(values.astype(np.int64))
            cmp[pick, 0], cmp[pick, 1] = h, l
        else:
            cmp[pick, 0] = values.astype(np.int32)
    return {**run, "planes": planes, "jax_arrays": jax_arrays(planes),
            "port": DeviceRun.from_reference_planes(planes, R, "cpu")}


def test_batch_of_33_with_odd_bounds_and_extremes_matches_pallas(
        extreme_run):
    """33 parameter rows of one signature, ranges with ends off the tile
    and vector width (empty and reversed ones too), three read points,
    literals at the i32/i64 extremes: each row equals its Pallas call."""
    run = extreme_run
    cid = run["cid"]
    aggs = all_aggs(cid)
    preds = (PredSig(cid["d"], "i32", ">="), PredSig(cid["a"], "i64", "<="))
    total = run["crun"].total_rows()
    reads = (run["max_ht"] + 1, (100 + run["max_ht"]) // 2, 150)
    lits = [(I32_LO, I64_HI), (I32_HI, I64_HI), (I32_LO, I64_LO),
            (-250_000, 10**13), (0, 0)]
    bounds = [(1, total - 3), (3, 131), (127, 129), (5, 5), (9, 7),
              (total - 5, total), (0, 1), (total // 2 + 1, total // 2 + 127),
              (0, total), (2, total - 1), (129, 1021)]
    rows = []
    for k in range(33):
        lo, hi = bounds[k % len(bounds)]
        x, y = lits[k % len(lits)]
        rows.append(params(run, aggs, preds, lo, hi, reads[k % 3],
                           [np.int32(x), lit_pair(y)]))
    got = check_same(run, aggs, preds, rows)
    full = got[0]
    assert full[0] > 0  # the full-range spec with the loosest literals
    vals = check_same(run, aggs, (), [params(run, aggs, (), 0, total,
                                             reads[0])])[0][2]
    # MIN/MAX see the extremes that were planted.
    assert vals[4] == I64_LO and vals[5] == I64_HI
    assert vals[6] == I32_LO and vals[7] == I32_HI


def lit_pair(v: int) -> np.ndarray:
    return np.array(P.i64_to_ordered_planes(
        np.array([v], np.int64))).ravel().astype(np.int32)
